"""The combiner flush thread: bucket pending tickets, dispatch, scatter.

The port's copy of ``distilp_tpu/combine/combiner.py``; every flush solves
on the combiner's ``device`` (None = cuda, raising without a GPU; ``'cpu'``
runs the kernels' plain versions). One background thread owns the buckets. ``submit`` (called from shard
worker threads) files a prepared ticket under its packed signature and
wakes the thread; the thread flushes a bucket when it reaches the
policy's lane cap (``combine_flush_full``) or when its oldest lane has
waited ``max_wait_ms`` (``combine_flush_deadline``). A flush is ONE
``solver.batchlayout.solve_batch`` call — one batched search — and each decoded lane is handed to its entry's ``deliver``
callback (the gateway enqueues the shard's ``adopt_combine`` there; a
dispatch failure delivers the error instead, and the shard falls back to
a local solve). The combiner never touches scheduler state itself: it
only moves packed blobs in and decoded results out, which is what makes
it safe to run off every shard's worker thread.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional

from .policy import BucketPolicy
from ..utils.lockwatch import make_lock


class CombineEntry:
    """One shard's pending lane: the scheduler ticket plus the delivery
    callback ``deliver(decoded, error)`` invoked on the combiner thread
    exactly once (decoded is the lane's ``(per_k_results, best)``)."""

    __slots__ = ("ticket", "deliver")

    def __init__(self, ticket, deliver: Callable):
        self.ticket = ticket
        self.deliver = deliver


class SolveCombiner:
    """Groups prepared tickets into signature buckets and dispatches one
    batched solve per bucket. Thread-safe ``submit``; ``stop()`` drains
    every pending bucket before joining, so no waiter is ever stranded."""

    def __init__(self, policy: Optional[BucketPolicy] = None, metrics=None,
                 device=None):
        from ..kernels import resolve_device

        self.policy = policy if policy is not None else BucketPolicy()
        self.metrics = metrics
        self.device = resolve_device(device, "SolveCombiner")
        self._cv = make_lock("combiner.buckets", kind="condition")
        # signature -> [(entry, enqueue_monotonic), ...] in arrival order.
        self._buckets: Dict[tuple, List[tuple]] = {}  # guarded-by: self._cv
        self._stopping = False  # guarded-by: self._cv
        self._stopped = False  # guarded-by: self._cv
        # Lifetime stats for /signals, guarded by the same condition lock.
        self._stats = {  # guarded-by: self._cv
            "batches": 0,
            "instances": 0,
            "flush_full": 0,
            "flush_deadline": 0,
            "errors": 0,
            "occupancy_sum": 0.0,
            "padding_waste_sum": 0.0,
        }
        self._thread = threading.Thread(
            target=self._run, name="solve-combiner", daemon=True
        )
        self._thread.start()

    # -- producer side -----------------------------------------------------

    def submit(self, entry: CombineEntry) -> None:
        """File one prepared lane; wakes the flush thread. After ``stop``
        began, delivers an error immediately instead of queueing into a
        bucket nobody will flush."""
        with self._cv:
            if self._stopping:
                stopped = True
            else:
                stopped = False
                sig = entry.ticket.prep.instance.signature
                self._buckets.setdefault(sig, []).append(
                    (entry, time.monotonic())
                )
                self._cv.notify()
        if stopped:
            self._deliver(entry, None, RuntimeError("combiner is stopped"))

    def snapshot(self) -> dict:
        """Lifetime counters + live occupancy for /signals' combine block."""
        with self._cv:
            pending = sum(len(v) for v in self._buckets.values())
            s = dict(self._stats)
            live_buckets = len(self._buckets)
        batches = s.pop("batches")
        occ_sum = s.pop("occupancy_sum")
        waste_sum = s.pop("padding_waste_sum")
        return {
            "batches": batches,
            "instances": s["instances"],
            "flush_full": s["flush_full"],
            "flush_deadline": s["flush_deadline"],
            "errors": s["errors"],
            "pending": pending,
            "buckets": live_buckets,
            "occupancy_mean": (occ_sum / batches) if batches else None,
            "padding_waste_mean": (waste_sum / batches) if batches else None,
        }

    def stop(self) -> None:
        """Drain every pending bucket (final deadline flushes), then join."""
        with self._cv:
            self._stopping = True
            self._cv.notify()
        self._thread.join()

    # -- flush thread ------------------------------------------------------

    def _run(self) -> None:
        wait_s = max(self.policy.max_wait_ms, 0.1) / 1e3
        while True:
            with self._cv:
                while not self._stopping and self._take_ready(peek=True) is None:
                    self._cv.wait(timeout=wait_s)
                batch = self._take_ready(final=self._stopping)
                if batch is None and self._stopping:
                    self._stopped = True
                    return
            if batch is not None:
                reason, entries = batch
                self._flush(reason, entries)

    def _take_ready(self, peek: bool = False, final: bool = False):
        """Under the lock: the next flushable bucket, or None. ``final``
        (stop-time drain) makes every non-empty bucket flushable."""
        now = time.monotonic()
        deadline_s = self.policy.max_wait_ms / 1e3
        for sig, lanes in self._buckets.items():
            cap = self.policy.lane_cap(lanes[0][0].ticket.prep.instance.M_pad)
            if len(lanes) >= cap:
                if peek:
                    return True
                take, rest = lanes[:cap], lanes[cap:]
                if rest:
                    self._buckets[sig] = rest
                else:
                    del self._buckets[sig]
                return "full", [e for e, _ in take]
            if final or (now - lanes[0][1]) >= deadline_s:
                if peek:
                    return True
                del self._buckets[sig]
                return ("deadline", [e for e, _ in lanes])
        return None

    def _flush(self, reason: str, entries: List[CombineEntry]) -> None:
        from ..solver.batchlayout import solve_batch

        t0 = time.perf_counter()
        tm: dict = {}
        m_pad = entries[0].ticket.prep.instance.M_pad
        lanes = self.policy.quantize_lanes(len(entries), m_pad)
        try:
            decoded = solve_batch(
                [e.ticket.prep.instance for e in entries],
                timings=tm,
                lane_pad=lanes,
                device=self.device,
            )
        except BaseException as err:
            with self._cv:
                self._stats["errors"] += 1
            if self.metrics is not None:
                self.metrics.inc("combine_dispatch_error")
            for e in entries:
                self._deliver(e, None, err)
            return
        ms = (time.perf_counter() - t0) * 1e3
        n = len(entries)
        waste = sum(
            1.0 - e.ticket.prep.instance.M_real / e.ticket.prep.instance.M_pad
            for e in entries
        ) / n
        with self._cv:
            self._stats["batches"] += 1
            self._stats["instances"] += n
            self._stats["flush_full" if reason == "full" else "flush_deadline"] += 1
            self._stats["occupancy_sum"] += n
            self._stats["padding_waste_sum"] += waste
        if self.metrics is not None:
            self.metrics.inc("combine_batches")
            self.metrics.inc("combine_instances", n)
            self.metrics.inc(
                "combine_flush_full" if reason == "full"
                else "combine_flush_deadline"
            )
            self.metrics.observe("combine_bucket_occupancy", float(n))
            self.metrics.observe("combine_padding_waste", waste)
            self.metrics.observe("combine_batch_ms", ms)
            if "static_hit" in tm:
                self.metrics.observe("combine_static_hit", tm["static_hit"])
        for e, d in zip(entries, decoded):
            self._deliver(e, d, None)

    def _deliver(self, entry: CombineEntry, decoded, err) -> None:
        """Invoke one delivery callback; a dead callback must not kill the
        flush thread (same contract as the worker completion callbacks)."""
        try:
            entry.deliver(decoded, err)
        except Exception:
            if self.metrics is not None:
                self.metrics.inc("worker_callback_error")
