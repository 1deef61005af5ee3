"""The solve worker: one thread owning N shards' schedulers.

The port's copy of ``distilp_tpu/gateway/worker.py``.

A ``ShardWorker`` is a single daemon thread draining a command queue.
Everything that touches a shard's ``Scheduler`` — event ticks, snapshot
dumps, state restores, health reads — runs as a queued closure ON the
worker thread, so per-shard work is serialized by construction: one shard
is only ever solved by its owning worker, warm-state writes never race,
and all of the scheduler's chaos machinery (quarantine, deadlines, breaker,
HealthState) runs unchanged inside the worker because the ``Scheduler``
it wraps IS the single-daemon scheduler.

The thread is a daemon for the same reason ``sched._SolveWorker``'s is:
an abandoned solve deep inside device code cannot be interrupted,
and a non-daemon thread would block process exit on it. ``stop()`` is the
graceful path (drains the queue, closes every scheduler); the daemon flag
is the crash path.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional

from ..sched.metrics import SchedulerMetrics
from ..sched.scheduler import Scheduler
from ..utils.lockwatch import make_lock


class WorkerQueueFull(Exception):
    """A bounded ``submit`` found the worker's queue at its limit.

    Deliberately NOT a RuntimeError: the HTTP tier maps RuntimeError to
    409 (retriable server state) and this to 429 + Retry-After — an
    aliasing subclass would silently misclassify sheds. Carries the depth
    observed under the submit lock (the authoritative reading — a racing
    caller-side ``depth()`` probe is advisory only).
    """

    def __init__(self, worker_id: int, depth: int):
        super().__init__(
            f"worker {worker_id} queue is full ({depth} queued)"
        )
        self.worker_id = worker_id
        self.depth = depth


class ShardWorker:
    """One solve thread + the shards it owns (shard_key -> Scheduler)."""

    def __init__(self, worker_id: int, metrics: SchedulerMetrics):
        self.worker_id = worker_id
        self.metrics = metrics  # gateway-level, thread-safe sink
        # Owned and mutated ONLY on the worker thread (via queued
        # closures). Reads from other threads are sanctioned only when the
        # worker is quiescent (e.g. the serve CLI's sequential replay).
        self.shards: Dict[str, Scheduler] = {}
        self._q: "queue.Queue" = queue.Queue()
        self._stopped = False  # guarded-by: self._submit_lock
        # Serializes submit()'s stopped-check-then-put against stop()'s
        # sentinel put: without it a submitter that passed the check could
        # enqueue AFTER the stop sentinel — the item would never run and
        # its waiter would hang forever instead of getting the RuntimeError.
        self._submit_lock = make_lock("worker.submit")
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"gw-worker-{worker_id}"
        )
        self._thread.start()

    # -- the queue protocol ------------------------------------------------

    def submit(
        self,
        fn: Callable,
        on_done: Optional[Callable[[dict], None]] = None,
        bound: Optional[int] = None,
    ):
        """Enqueue ``fn`` for the worker thread.

        Returns ``(box, done)``: wait on the threading.Event, then read
        ``box['result']`` or re-raise ``box['exc']``. ``on_done(box)``
        (optional) fires on the worker thread after ``done`` is set — the
        asyncio ingest path uses it to resolve a loop future via
        ``call_soon_threadsafe`` instead of parking an executor thread per
        in-flight event.

        ``bound`` is the admission gate: when the queue already holds that
        many commands, raise ``WorkerQueueFull`` instead of enqueueing.
        The check runs under the submit lock, so the bound cannot be
        overshot by racing submitters — this is where load shedding is
        DECIDED; the gateway turns the raise into a counted, flight-
        recorded 429. Control-plane submits (health probes, snapshots,
        stop) pass no bound: observability must stay answerable exactly
        when the queue is full.
        """
        box: dict = {}
        done = threading.Event()
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError(f"worker {self.worker_id} is stopped")
            if bound is not None:
                depth = self._q.qsize()
                if depth >= bound:
                    raise WorkerQueueFull(self.worker_id, depth)
            self._q.put((fn, box, done, on_done))
        return box, done

    def call(self, fn: Callable, timeout: Optional[float] = None):
        """Synchronous round trip: run ``fn`` on the worker, return/raise."""
        box, done = self.submit(fn)
        if not done.wait(timeout=timeout):
            raise TimeoutError(
                f"worker {self.worker_id} did not answer within {timeout}s"
            )
        if "exc" in box:
            raise box["exc"]
        return box["result"]

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fn, box, done, on_done = item
            try:
                box["result"] = fn()
            except BaseException as e:
                # Not swallowed: the caller re-raises from the box; the
                # counter keeps worker-side failures visible even when a
                # caller abandons its wait.
                self.metrics.inc("worker_exception")
                box["exc"] = e
            finally:
                done.set()
                if on_done is not None:
                    try:
                        on_done(box)
                    except Exception:
                        # A dead completion callback (e.g. the asyncio
                        # loop closed mid-flight: call_soon_threadsafe
                        # raises) must not kill the worker thread — that
                        # would strand every queued waiter forever.
                        self.metrics.inc("worker_callback_error")

    def depth(self) -> int:
        """Commands queued but not yet finished (the backpressure gauge)."""
        return self._q.qsize()

    # -- the shard lifecycle seam ------------------------------------------
    #
    # Gateway talks to shards ONLY through these four verbs plus queued
    # closures over ``self.shards``. ``ProcShardWorker`` overrides just
    # ``create_shard`` (a subprocess cannot run the parent's build closure;
    # it needs the picklable ``spec``) — everything else rides the same
    # closures because its ``shards`` dict holds RPC proxies that quack
    # like ``Scheduler``.

    def create_shard(self, key: str, build: Callable, state=None, spec=None):
        """Build a shard's scheduler ON the worker thread and install it.

        ``build`` is a zero-arg closure returning a ready ``Scheduler``;
        ``spec`` is the picklable equivalent that process workers need
        (thread workers ignore it). ``state`` (a ``dump_state`` blob) is
        loaded before the shard is published, so the first tick it ever
        serves is already warm-restored.
        """
        def _do():
            sched = build()
            if state is not None:
                sched.load_state(state)
            self.shards[key] = sched

        self.call(_do)

    def dump_shard(self, key: str):
        """Snapshot one shard behind everything already queued (FIFO)."""
        return self.call(lambda: self.shards[key].dump_state())

    def load_shard(self, key: str, state) -> None:
        """Restore a snapshot into an existing shard (re-arms warm audit)."""
        self.call(lambda: self.shards[key].load_state(state))

    def drop_shard(self, key: str) -> None:
        """Remove and close one shard (the source side of a migration)."""
        def _do():
            sched = self.shards.pop(key)
            sched.close()

        self.call(_do)

    def stop(self, join: bool = True, timeout: float = 5.0) -> None:
        """Graceful shutdown: drain the queue, close every scheduler.

        Queued work ahead of the stop sentinel still runs (a drain IS
        queued work); the close runs on the worker thread itself so it
        never races an in-flight tick.
        """
        def _close_all() -> None:
            for sched in self.shards.values():
                sched.close()

        # Under the submit lock so the sentinel is strictly LAST: no item
        # can slip in behind it and hang its waiter (see _submit_lock).
        with self._submit_lock:
            if self._stopped:
                return
            self._stopped = True
            self._q.put((_close_all, {}, threading.Event(), None))
            self._q.put(None)
        if join:
            self._thread.join(timeout=timeout)
