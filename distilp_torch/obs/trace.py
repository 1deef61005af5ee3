"""Span-based tracing for the serving path: where did an event's time go?

One churn event's journey — HTTP parse, shard routing, the wait on the
owning worker's queue, the scheduler tick, the solve, the publish — is a
TREE of spans sharing one ``trace_id``. Each span carries wall-clock start
and duration, free-form attributes (the solver's ``timings`` dict rides
the solve span), and point-in-time events (quarantine decisions, breaker
transitions, health changes). Finished spans land in a lock-protected
bounded ring and, optionally, a JSONL writer (``serve --trace-spans-dir``);
``solver spans`` converts that JSONL into Chrome trace-event JSON
(Perfetto / chrome://tracing loadable — see ``obs.export``).

Off by default, and the disabled path is a no-op: every instrumentation
site talks to a tracer-shaped object, and :data:`NOOP_TRACER` answers all
of it with shared do-nothing singletons — no ids minted, no clocks read,
no locks taken — so ``--workers 1`` serving without the flag stays
byte-identical to the uninstrumented daemon (pinned by the smoke gates'
counter assertions).

Parenting across threads is EXPLICIT, never ambient: asyncio code passes
``SpanContext`` objects (a thread-local "current span" would leak between
interleaved coroutines on the loop thread and mis-parent spans), while the
synchronous scheduler path uses the per-thread stack — ``with
tracer.span(...)`` nests, and a worker thread adopts a foreign context via
``tracer.attach(ctx)`` before running a tick, so the tick's spans parent
under the gateway ingest span that enqueued it.

All span timestamps are ``time.perf_counter()`` milliseconds: monotonic,
comparable across threads of one process (which is all a trace ever
spans), and exactly what the Chrome converter wants.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

from ..utils.lockwatch import make_lock

__all__ = [
    "Span",
    "SpanContext",
    "Tracer",
    "NOOP_TRACER",
    "NOOP_SPAN",
    "JsonlSpanWriter",
    "now_ms",
]

# One process-wide id mint: `next()` on an itertools.count is atomic under
# the GIL, so ids are unique across worker threads without a lock.
_IDS = itertools.count(1)

# Sentinel: "parent not given — use the calling thread's current span".
_CURRENT = object()


def now_ms() -> float:
    """The tracer's clock: monotonic milliseconds (perf_counter)."""
    return time.perf_counter() * 1e3


def _next_id() -> str:
    return f"{next(_IDS):012x}"


class SpanContext(NamedTuple):
    """The propagatable identity of a span (what children parent to)."""

    trace_id: str
    span_id: str


def _clean(value: Any):
    """Attribute values must survive json.dumps; coerce the near-misses
    (numpy scalars from the solver's timings dict) and stringify the rest."""
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    try:
        return float(value)
    except (TypeError, ValueError):  # dlint: disable=DLP017 type-coercion fallback (str repr), not fault recovery — nothing is swallowed
        return str(value)


class Span:
    """One timed unit of work; record lands in the tracer ring on end().

    Usable as a context manager (``with tracer.span(...)``: participates in
    the thread-local nesting stack) or started/ended manually via
    ``tracer.start_span`` + ``end()`` (no stack participation — the asyncio
    idiom, where explicit parents are the only sound propagation).
    """

    __slots__ = (
        "_tracer", "name", "trace_id", "span_id", "parent_id",
        "t0_ms", "attrs", "events", "thread", "_ended",
    )

    def __init__(
        self,
        tracer: "Tracer",
        name: str,
        trace_id: str,
        parent_id: Optional[str],
        attrs: Optional[dict] = None,
    ):
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = _next_id()
        self.parent_id = parent_id
        self.t0_ms = now_ms()
        self.attrs: Dict[str, Any] = (
            {k: _clean(v) for k, v in attrs.items()} if attrs else {}
        )
        self.events: List[dict] = []
        self.thread = threading.current_thread().name
        self._ended = False

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = _clean(value)

    def add_event(self, name: str, **attrs) -> None:
        ev = {"name": name, "t_ms": now_ms()}
        for k, v in attrs.items():
            ev[k] = _clean(v)
        self.events.append(ev)

    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def end(self) -> None:
        if self._ended:  # idempotent: error paths may end twice
            return
        self._ended = True
        self._tracer._record(self)

    def __enter__(self) -> "Span":
        self._tracer._push(self.context())
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._pop()
        self.end()
        return False


class _NoopSpan:
    """The disabled path: one shared instance, every method a no-op."""

    __slots__ = ()

    def set_attr(self, key: str, value) -> None:
        pass

    def add_event(self, name: str, **attrs) -> None:
        pass

    def context(self) -> None:
        return None

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class _Attach:
    """Context manager installing a foreign SpanContext as the calling
    thread's current span (the worker-thread adoption idiom)."""

    __slots__ = ("_tracer", "_ctx")

    def __init__(self, tracer: "Tracer", ctx: Optional[SpanContext]):
        self._tracer = tracer
        self._ctx = ctx

    def __enter__(self) -> "_Attach":
        if self._ctx is not None:
            self._tracer._push(self._ctx)
        return self

    def __exit__(self, *exc) -> bool:
        if self._ctx is not None:
            self._tracer._pop()
        return False


class Tracer:
    """Collects finished spans into a bounded ring (+ optional writer).

    Thread safety: the ring append and the writer flush happen under one
    lock (spans finish on gateway workers, the asyncio loop thread and the
    replay thread at once); the per-thread nesting stack is thread-local
    and needs none.
    """

    enabled = True

    def __init__(self, capacity: int = 8192, writer=None):
        if capacity < 1:
            raise ValueError("tracer ring capacity must be >= 1")
        self._ring: "deque[dict]" = deque(maxlen=capacity)  # guarded-by: self._lock
        self._lock = make_lock("trace.ring")
        self._writer = writer
        self._local = threading.local()
        self.dropped = 0  # writer failures (serving outranks span loss)

    # -- the thread-local nesting stack ------------------------------------

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _push(self, ctx: SpanContext) -> None:
        self._stack().append(ctx)

    def _pop(self) -> None:
        st = self._stack()
        if st:
            st.pop()

    def current(self) -> Optional[SpanContext]:
        st = self._stack()
        return st[-1] if st else None

    def attach(self, ctx: Optional[SpanContext]) -> _Attach:
        """Adopt ``ctx`` as this thread's current span (None = no-op)."""
        return _Attach(self, ctx)

    # -- span lifecycle ----------------------------------------------------

    def _resolve(self, parent) -> tuple:
        """(trace_id, parent_id) for a new span under ``parent``."""
        if parent is _CURRENT:
            parent = self.current()
        if parent is None:
            return _next_id(), None
        return parent.trace_id, parent.span_id

    def span(self, name: str, parent=_CURRENT, attrs: Optional[dict] = None) -> Span:
        """A span for ``with``: enters the thread-local nesting stack."""
        trace_id, parent_id = self._resolve(parent)
        return Span(self, name, trace_id, parent_id, attrs)

    def start_span(
        self, name: str, parent=_CURRENT, attrs: Optional[dict] = None
    ) -> Span:
        """A manually ended span: never touches the nesting stack (use for
        asyncio code, where the stack would leak across coroutines)."""
        trace_id, parent_id = self._resolve(parent)
        return Span(self, name, trace_id, parent_id, attrs)

    def record_span(
        self,
        name: str,
        t0_ms: float,
        t1_ms: Optional[float] = None,
        parent: Optional[SpanContext] = None,
        attrs: Optional[dict] = None,
    ) -> SpanContext:
        """Record a span after the fact from explicit timestamps — the
        queue-wait idiom: enqueue time was noted on the submitting thread,
        the span materializes at pickup on the worker thread."""
        trace_id, parent_id = self._resolve(parent)
        span = Span(self, name, trace_id, parent_id, attrs)
        span.t0_ms = t0_ms
        span._ended = True  # recorded below, never via end()
        self._record(span, t1_ms=t1_ms if t1_ms is not None else now_ms())
        return span.context()

    def _record(self, span: Span, t1_ms: Optional[float] = None) -> None:
        rec = {
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "name": span.name,
            "t0_ms": round(span.t0_ms, 3),
            "dur_ms": round((t1_ms if t1_ms is not None else now_ms()) - span.t0_ms, 3),
            "thread": span.thread,
            "attrs": span.attrs,
            "events": span.events,
        }
        with self._lock:
            self._ring.append(rec)
            if self._writer is not None:
                try:
                    self._writer.write(rec)  # dlint: disable=DLP031 file order must match ring order; the writer is line-buffered JSONL and a span record is tiny
                except OSError:  # dlint: disable=DLP017 accounted in self.dropped; the tracer has no metrics sink and span loss must never fail a tick
                    self.dropped += 1

    # -- the read side -----------------------------------------------------

    def drain(self) -> List[dict]:
        """Snapshot-and-clear of the finished-span ring."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def spans(self) -> List[dict]:
        """Snapshot of the finished-span ring (ring left intact)."""
        with self._lock:
            return list(self._ring)

    def close(self) -> None:
        with self._lock:
            if self._writer is not None:
                self._writer.close()
                self._writer = None


class _NoopTracer:
    """The disabled tracer: every call answers with shared no-ops. No ids,
    no clock reads, no locks — instrumentation sites cost an attribute
    lookup and a constant return."""

    enabled = False

    def span(self, name, parent=_CURRENT, attrs=None) -> _NoopSpan:
        return NOOP_SPAN

    def start_span(self, name, parent=_CURRENT, attrs=None) -> _NoopSpan:
        return NOOP_SPAN

    def record_span(self, name, t0_ms, t1_ms=None, parent=None, attrs=None):
        return None

    def attach(self, ctx) -> _NoopSpan:
        return NOOP_SPAN

    def current(self) -> None:
        return None

    def drain(self) -> list:
        return []

    def spans(self) -> list:
        return []

    def close(self) -> None:
        pass


NOOP_TRACER = _NoopTracer()


class JsonlSpanWriter:
    """Append-only JSONL sink for finished spans (one object per line).

    The tracer serializes calls under its own lock, so the writer itself
    stays lock-free; ``default=str`` keeps an exotic attribute value from
    ever killing a tick over a log line.
    """

    def __init__(self, path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self.written = 0

    def write(self, record: dict) -> None:
        self._fh.write(json.dumps(record, default=str) + "\n")
        self.written += 1

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            self._fh.close()
            self._fh = None
