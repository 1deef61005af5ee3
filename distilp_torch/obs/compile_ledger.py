"""Compile ledger: the card's cold-start telemetry for the serving stack.

The port's counterpart of ``distilp_tpu/obs/compile_ledger.py``. The port
runs no XLA compiles; two things cost it the same kind of cold,
dispatch-blocking time on the card, and they are its compile events:

- **Kernel builds and loads.** ``kernels.build.load_all`` records one event
  per kernel library: an ``nvcc`` run is ``cold`` (a miss of the on-disk
  build cache), a library found in that cache by its content hash is
  ``cache_hit``. They are attributed to ``kernels.build`` (static
  signature: the library; shape signature: its content hash).
- **CUDA-graph captures.** ``solver.device_loop.LoopPlan`` records one
  event per capture and instantiation of a loop plan's graph, attributed to
  the innermost instrumented entry point on the capturing thread's stack,
  or to ``(unregistered)`` when there is none. The plan signature supplies
  the static signature (``per_k``, iteration budgets, warm flags, the
  engine's route) and the shape signature (lanes, frontier capacity, the
  standard form's and the sparse structure's sizes).
- **Entry-point registry.** Every device entry point of the port (the
  solver's sweep, scenario and batch entries, the LP batch entries, the
  decomposition bound, the twin's Monte-Carlo) is wrapped once via
  :func:`instrument`: a transparent passthrough while no ledger is
  enabled (one module-global read per dispatch); with a ledger enabled it
  counts dispatches and pushes its name onto a thread-local context stack
  for the duration of the call.
- **Cause taxonomy.** Each event is classified against the entry point's
  signature history: ``cold`` (first compile ever, and every ``nvcc``
  run), ``cache_hit`` (the build cache served the library),
  ``static_arg_flip`` (a new ``per_k``, iteration budget or engine),
  ``shape_bucket_change`` (same statics, new sizes) and ``recompile`` (an
  exact signature captured AGAIN: a plan evicted from the plan cache and
  rebuilt, or a second plan of one signature for a second solve in
  flight).
- **Recompile-storm alarm.** N compiles of the same entry point inside a
  sliding window mark the event ``storm`` and bump the ledger's storm
  counter; the scheduler surfaces storms as the ``recompile_storms``
  metric.
- **Cost attribution** (``cost_analysis=True``): the port has no compiler
  cost model to ask, so an entry point's first compile records FLOPs and
  bytes as ``None``: absent, never zero.

Stdlib-only at import time and opt-in: with no ledger enabled the
instrumented entry points run the exact pre-ledger path.

The JSONL dump follows the flight-recorder convention (header line +
one event per line) and round-trips byte-stably; :func:`render_report`
is a pure function of a dump (the JAX package's, byte for byte), so
``compiles`` renders the same bytes on every replay.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

from ..utils.lockwatch import make_lock

__all__ = [
    "CompileLedger",
    "InstrumentedJit",
    "instrument",
    "registered_entry_points",
    "set_dispatch_hook",
    "parse_cost_analysis",
    "enable",
    "disable",
    "current",
    "ledger_to_jsonl",
    "ledger_from_jsonl",
    "render_report",
    "CAUSES",
    "BUILD_ENTRY",
    "UNREGISTERED",
    "note_build",
    "note_capture",
    "capture_open",
    "capturing",
    "entry_stack",
    "attributed",
    "innermost_entry",
]

CAUSE_COLD = "cold"
CAUSE_CACHE_HIT = "cache_hit"
CAUSE_STATIC_FLIP = "static_arg_flip"
CAUSE_SHAPE = "shape_bucket_change"
CAUSE_RECOMPILE = "recompile"
CAUSES = (
    CAUSE_COLD, CAUSE_CACHE_HIT, CAUSE_STATIC_FLIP, CAUSE_SHAPE,
    CAUSE_RECOMPILE,
)

# Attribution bucket for captures that ran with no instrumented entry
# point on the capturing thread's stack.
UNREGISTERED = "(unregistered)"
# The entry point every kernel-library build and load is attributed to.
BUILD_ENTRY = "kernels.build"

# name -> {"static_argnames": (...,)}: the process-wide entry-point
# registry. Populated at import time by the instrument() sites, so the
# expected cold-compile surface is enumerable without enabling anything.
_REGISTRY: Dict[str, dict] = {BUILD_ENTRY: {"static_argnames": ("library",)}}

_tls = threading.local()
_LEDGER: Optional["CompileLedger"] = None
_LEDGER_LOCK = make_lock("compile_ledger.global")
# Registry ride-along (obs.memory): one callable invoked per dispatch of
# every instrumented entry point, BEFORE the call — (wrapper, args,
# kwargs) — which returns None or a callable ``finish(result)`` run after
# the call. None (the default) keeps the passthrough path at one extra
# module-global read; the hook owner is responsible for its own dormancy
# check and for never raising into the dispatch.
_DISPATCH_HOOK = None


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def parse_cost_analysis(cost) -> Tuple[Optional[float], Optional[float]]:
    """(flops, bytes_accessed) from a cost-analysis blob: a dict, or a
    one-element list of dicts (the dump format both packages share). The
    port has no compiler to produce one: its ledgers record None."""
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    if not hasattr(cost, "get"):
        return None, None
    flops = cost.get("flops")
    bytes_accessed = cost.get("bytes accessed")
    return (
        float(flops) if flops is not None else None,
        float(bytes_accessed) if bytes_accessed is not None else None,
    )


class CompileLedger:
    """Process-wide compile/dispatch ledger (see module docstring).

    All mutation happens under one re-entrant lock: wrappers dispatch from
    many shard-worker threads while builds and captures are recorded and a
    timeline sampler reads the counters.
    """

    def __init__(
        self,
        capacity: int = 4096,
        storm_threshold: int = 5,
        storm_window_s: float = 60.0,
        cost_analysis: bool = False,
    ):
        if capacity < 1:
            raise ValueError("compile ledger capacity must be >= 1")
        if storm_threshold < 2:
            raise ValueError("storm threshold must be >= 2")
        self.capacity = capacity
        self.storm_threshold = storm_threshold
        self.storm_window_s = storm_window_s
        self.cost_analysis = cost_analysis
        # The dump's "fallback" field: the JAX package's ledger sets it when
        # it must infer compiles from first-seen signatures. The port's
        # events are observed directly, so it stays False.
        self.fallback = False
        self._lock = make_lock("compile_ledger.entries", kind="rlock")
        self._t0 = time.monotonic()
        self.events: "deque[dict]" = deque(maxlen=capacity)
        self._seq = 0  # total compile events ever (ring may have evicted)
        self.dispatches: Dict[str, int] = {}
        self.compiles: Dict[str, int] = {}
        self.compile_ms: Dict[str, float] = {}
        self.entry_cache_hits: Dict[str, int] = {}
        self.causes: Dict[str, int] = {}
        self.cache_hits = 0
        self.cache_misses = 0
        self.cache_requests = 0
        self.storms = 0
        self.unattributed = 0
        self.costs: Dict[str, dict] = {}
        self.cost_errors = 0
        # Classification state: per entry, the (static, shape) signatures
        # compiled so far and the statics seen — what separates a flip
        # from a shape-bucket change from an outright recompile.
        self._sigs: Dict[str, Dict[Tuple[str, str], int]] = {}
        self._statics: Dict[str, set] = {}
        # Storm detection: per entry, recent compile timestamps.
        self._recent: Dict[str, deque] = {}
        self._storming: Dict[str, bool] = {}

    # -- the write side ----------------------------------------------------

    def seq(self) -> int:
        """Monotonic compile-event counter — the capture token the
        scheduler snapshots around a tick (``events_since``)."""
        with self._lock:
            return self._seq

    def note_dispatch(self, entry: str) -> None:
        with self._lock:
            self.dispatches[entry] = self.dispatches.get(entry, 0) + 1

    def note_compile(
        self,
        entry: str,
        static_sig: str,
        shape_sig: str,
        ms: float,
        cache: Optional[str] = None,
        cause: Optional[str] = None,
    ) -> dict:
        """Record one compile event and classify its cause (``cause``
        overrides the classification: an ``nvcc`` run is ``cold``)."""
        now = time.monotonic()
        with self._lock:
            self._seq += 1
            sigs = self._sigs.setdefault(entry, {})
            statics = self._statics.setdefault(entry, set())
            key = (static_sig, shape_sig)
            if cause is not None:
                pass
            elif cache == "hit":
                cause = CAUSE_CACHE_HIT
            elif not sigs:
                cause = CAUSE_COLD
            elif key in sigs:
                cause = CAUSE_RECOMPILE
            elif static_sig not in statics:
                cause = CAUSE_STATIC_FLIP
            else:
                cause = CAUSE_SHAPE
            sigs[key] = sigs.get(key, 0) + 1
            statics.add(static_sig)
            # Storm window: compiles of THIS entry in the last window_s.
            # A process loads all its kernel libraries at once, each a
            # different library: only captures can storm.
            ring = self._recent.setdefault(entry, deque())
            if entry != BUILD_ENTRY:
                ring.append(now)
            while ring and now - ring[0] > self.storm_window_s:
                ring.popleft()
            storm = storm_start = False
            if len(ring) >= self.storm_threshold:
                storm = True
                if not self._storming.get(entry):
                    # ONE transition per episode: `storms` (and every
                    # consumer of it — the c.recompile_storms series,
                    # the scheduler's recompile_storms counter) counts
                    # alarms, while the per-event `storm` flag keeps
                    # marking every compile the episode contains.
                    storm_start = True
                    self._storming[entry] = True
                    self.storms += 1
            else:
                self._storming[entry] = False
            ev = {
                "seq": self._seq,
                "t": round(now - self._t0, 6),
                "thread": threading.get_ident(),
                "entry": entry,
                "cause": cause,
                "compile_ms": round(ms, 3),
                "cache": cache,
                "static": static_sig,
                "shapes": shape_sig,
            }
            if storm:
                ev["storm"] = True
            if storm_start:
                ev["storm_start"] = True
            self.events.append(ev)
            self.compiles[entry] = self.compiles.get(entry, 0) + 1
            self.compile_ms[entry] = (
                self.compile_ms.get(entry, 0.0) + ms
            )
            self.causes[cause] = self.causes.get(cause, 0) + 1
            if cache == "hit":
                self.cache_hits += 1
                self.entry_cache_hits[entry] = (
                    self.entry_cache_hits.get(entry, 0) + 1
                )
            elif cache == "miss":
                self.cache_misses += 1
            if entry == UNREGISTERED:
                self.unattributed += 1
            return ev

    # -- wrapper plumbing ----------------------------------------------------

    def _dispatch(self, wrapper: "InstrumentedJit", args, kwargs):
        entry = wrapper.entry_point
        self.note_dispatch(entry)
        stack = _stack()
        stack.append(entry)
        tok = self.seq()
        try:
            return wrapper._fn(*args, **kwargs)
        finally:
            stack.pop()
            if self.cost_analysis:
                compiled = any(
                    e["entry"] == entry and e["cause"] != CAUSE_CACHE_HIT
                    for e in self.events_since(tok)
                )
                if compiled:
                    with self._lock:
                        # No compiler cost model on the card: absent.
                        self.costs.setdefault(
                            entry, {"flops": None, "bytes_accessed": None}
                        )

    # -- the read side -----------------------------------------------------

    def events_since(
        self, token: int, threads: Optional[set] = None
    ) -> List[dict]:
        """Events recorded after ``token`` (a prior ``seq()`` read),
        optionally filtered to the given thread idents — the scheduler
        passes its own solve threads so concurrent shards' compiles are
        never cross-billed to this tick."""
        with self._lock:
            out = [e for e in self.events if e["seq"] > token]
        if threads is not None:
            out = [e for e in out if e.get("thread") in threads]
        return out

    def counters(self) -> dict:
        """Flat totals for timeline emission / serve summaries."""
        with self._lock:
            return {
                "compiles": self._seq,
                "compile_cache_hits": self.cache_hits,
                "compile_cache_misses": self.cache_misses,
                "compile_cache_requests": self.cache_requests,
                "compile_ms_total": round(
                    sum(self.compile_ms.values()), 3
                ),
                "recompile_storms": self.storms,
                "dispatches": sum(self.dispatches.values()),
                "unattributed_compiles": self.unattributed,
            }

    def timeline_series(self) -> Dict[str, float]:
        """The ledger's timeline emission — ONE definition shared by
        ``Scheduler.timeline_sample`` and ``Gateway.timeline_sample`` so
        the two serving shapes' series names cannot drift. Cumulative,
        zero-valued from the first sample (a counter minted mid-incident
        has no baseline), emitted only while a ledger is enabled so
        feature-off samples stay byte-identical."""
        c = self.counters()
        return {
            "c.compiles": float(c["compiles"]),
            "c.compile_cache_hits": float(c["compile_cache_hits"]),
            "c.recompile_storms": float(c["recompile_storms"]),
            "compile_ms": float(c["compile_ms_total"]),
        }

    def cache_hit_rate(self) -> Optional[float]:
        """Build-cache hit rate over kernel-library loads; None when no
        library was loaded under the ledger (hits and misses both zero)."""
        with self._lock:
            total = self.cache_hits + self.cache_misses
            if total == 0:
                return None
            return self.cache_hits / total

    def summary(self) -> dict:
        """Per-entry-point table + cause histogram, JSON-able."""
        with self._lock:
            names = sorted(
                set(self.dispatches) | set(self.compiles) | set(_REGISTRY)
            )
            entries = {}
            for name in names:
                entries[name] = {
                    "registered": name in _REGISTRY,
                    "dispatches": self.dispatches.get(name, 0),
                    "compiles": self.compiles.get(name, 0),
                    "compile_ms": round(self.compile_ms.get(name, 0.0), 3),
                    "cache_hits": self.entry_cache_hits.get(name, 0),
                }
                if name in self.costs and self.costs[name]:
                    entries[name]["cost"] = dict(self.costs[name])
            return {
                "entries": entries,
                "causes": dict(sorted(self.causes.items())),
                "counters": self.counters(),
                "cache_hit_rate": self.cache_hit_rate(),
                "fallback": self.fallback,
            }

    def dump(self) -> dict:
        """The ledger as one JSON-able blob (header + event list)."""
        with self._lock:
            return {
                "header": {
                    "compile_ledger": 1,
                    "capacity": self.capacity,
                    "storm_threshold": self.storm_threshold,
                    "storm_window_s": self.storm_window_s,
                    "registry": sorted(_REGISTRY),
                    "summary": self.summary(),
                },
                "events": [dict(e) for e in self.events],
            }

    def to_jsonl(self) -> str:
        return ledger_to_jsonl(self.dump())

    def dump_jsonl(self, path) -> None:
        from pathlib import Path

        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_jsonl(), encoding="utf-8")


class InstrumentedJit:
    """Transparent wrapper around one device entry point of the port.

    With no ledger (and no memory ledger) enabled the call path is two
    module-global reads plus the call; attribute access forwards to the
    wrapped function. The name is the JAX package's, whose entry points
    are jitted functions.
    """

    __slots__ = ("entry_point", "_fn", "static_argnames")

    def __init__(self, entry_point: str, fn, static_argnames=()):
        self.entry_point = entry_point
        self._fn = fn
        self.static_argnames = tuple(static_argnames)

    def __call__(self, *args, **kwargs):
        hook = _DISPATCH_HOOK
        finish = None
        if hook is not None:
            # The memory ledger's registry ride-along (set_dispatch_hook):
            # its first-dispatch analysis brackets the call.
            finish = hook(self, args, kwargs)
        led = _LEDGER
        result = None
        try:
            if led is None:
                result = self._fn(*args, **kwargs)
            else:
                result = led._dispatch(self, args, kwargs)
            return result
        finally:
            if finish is not None:
                finish(result)

    def __getattr__(self, attr):
        return getattr(self._fn, attr)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"InstrumentedJit({self.entry_point!r}, {self._fn!r})"


def instrument(entry_point: str, fn, static_argnames=()) -> InstrumentedJit:
    """Register + wrap a device entry point
    (``fn = instrument("layer.name", fn)`` after its definition).

    Re-registering a name replaces the wrapped callable; the registry
    entry survives.
    """
    _REGISTRY[entry_point] = {"static_argnames": tuple(static_argnames)}
    return InstrumentedJit(entry_point, fn, static_argnames)


def registered_entry_points() -> List[str]:
    """Sorted names of every instrumented entry point imported so far —
    the expected cold-compile surface the ``compiles`` report checks
    compiles against."""
    return sorted(_REGISTRY)


def set_dispatch_hook(hook) -> None:
    """Install (or clear, with None) the per-dispatch registry hook —
    the seam ``obs.memory`` rides to model each entry point once.
    Process-wide like the ledger itself; the hook must check its own
    dormancy and swallow its own failures (a raising hook would take
    every instrumented dispatch down with it)."""
    global _DISPATCH_HOOK
    _DISPATCH_HOOK = hook


# -- the port's compile events ------------------------------------------------


def innermost_entry() -> str:
    """The innermost instrumented entry point on this thread's stack, or
    ``(unregistered)``."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else UNREGISTERED


def entry_stack() -> tuple:
    """This thread's entry-point stack, for work handed to another thread
    (:func:`attributed`)."""
    return tuple(getattr(_tls, "stack", None) or ())


@contextmanager
def attributed(entries: Sequence[str]):
    """Run the block with ``entries`` on this thread's stack: a search the
    caller's entry point dispatched to a worker thread is billed to it."""
    stack = _stack()
    n = len(stack)
    stack.extend(entries)
    try:
        yield
    finally:
        del stack[n:]


@contextmanager
def capture_open():
    """Mark a CUDA-graph capture open on this thread for the block: the
    memory ledger takes no sample and no analysis inside it (the
    counterpart of the JAX package's inner-trace check)."""
    prev = getattr(_tls, "capturing", False)
    _tls.capturing = True
    try:
        yield
    finally:
        _tls.capturing = prev


def capturing() -> bool:
    """Whether a graph capture is open on this thread."""
    return getattr(_tls, "capturing", False)


def note_build(library: str, digest: str, ms: float, nvcc_ran: bool) -> None:
    """One kernel library built (``nvcc_ran``: ``cold``, a build-cache
    miss) or taken from the on-disk build cache (``cache_hit``)."""
    led = _LEDGER
    if led is None:
        return
    if nvcc_ran:
        led.note_compile(BUILD_ENTRY, f"library={library!r}", digest, ms,
                         cache="miss", cause=CAUSE_COLD)
    else:
        led.note_compile(BUILD_ENTRY, f"library={library!r}", digest, ms,
                         cache="hit")


def note_capture(static_sig: str, shape_sig: str, ms: float) -> None:
    """One CUDA-graph capture and instantiation of a loop plan, billed to
    the innermost entry point on this thread."""
    led = _LEDGER
    if led is None:
        return
    led.note_compile(innermost_entry(), static_sig, shape_sig, ms)


# -- process-wide enable/disable ---------------------------------------------


def enable(ledger: Optional[CompileLedger] = None, **kwargs) -> CompileLedger:
    """Install ``ledger`` (or a fresh one built from ``kwargs``) as THE
    process ledger. Returns the installed ledger."""
    global _LEDGER
    with _LEDGER_LOCK:
        led = ledger if ledger is not None else CompileLedger(**kwargs)
        _LEDGER = led
        return led


def disable() -> Optional[CompileLedger]:
    """Detach the process ledger (the wrappers go dormant); returns it."""
    global _LEDGER
    with _LEDGER_LOCK:
        led, _LEDGER = _LEDGER, None
        return led


def current() -> Optional[CompileLedger]:
    return _LEDGER


# -- persistence + report (the flight-recorder JSONL convention) -------------


def ledger_to_jsonl(dump: dict) -> str:
    """Header line + one event per line; pure function of the dump, so
    ``to_jsonl(from_jsonl(s)) == s`` byte-for-byte."""
    lines = [json.dumps(dump["header"], sort_keys=True)]
    for ev in dump["events"]:
        lines.append(json.dumps(ev, sort_keys=True))
    return "\n".join(lines) + "\n"


def ledger_from_jsonl(text: str) -> dict:
    """Parse a dumped ledger back into the ``dump()`` shape."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty compile-ledger dump")
    header = json.loads(lines[0])
    if not isinstance(header, dict) or "compile_ledger" not in header:
        raise ValueError("compile-ledger dump missing its header line")
    if header["compile_ledger"] != 1:
        raise ValueError(
            f"unknown compile-ledger dump version {header['compile_ledger']!r}"
        )
    return {
        "header": header,
        "events": [json.loads(ln) for ln in lines[1:]],
    }


def render_report(dump: dict, top: int = 5) -> str:
    """Deterministic text report over a ``dump()``/``ledger_from_jsonl``
    blob: per-entry-point table, cause histogram, cache hit rate, top-N
    recompile offenders. No clocks, no thread ids — byte-identical on
    every replay of the same dump."""
    summary = dump["header"].get("summary", {})
    entries = summary.get("entries", {})
    causes = summary.get("causes", {})
    counters = summary.get("counters", {})
    out: List[str] = []
    out.append("compile ledger")
    out.append(
        "  compiles={compiles} dispatches={dispatches} "
        "storms={recompile_storms} unattributed={unattributed_compiles} "
        "compile_ms={compile_ms_total}".format(
            **{
                k: counters.get(k, 0)
                for k in (
                    "compiles", "dispatches", "recompile_storms",
                    "unattributed_compiles", "compile_ms_total",
                )
            }
        )
    )
    rate = summary.get("cache_hit_rate")
    out.append(
        "  persistent cache: "
        + (
            "not engaged (DISTILP_COMPILE_CACHE unset?)"
            if rate is None
            else "hit rate {:.1%} ({} hits / {} misses)".format(
                rate,
                counters.get("compile_cache_hits", 0),
                counters.get("compile_cache_misses", 0),
            )
        )
    )
    out.append("")
    out.append(
        f"  {'entry point':<34s} {'disp':>7s} {'compiles':>8s} "
        f"{'ms':>10s} {'hits':>5s}  registered"
    )
    for name in sorted(entries):
        e = entries[name]
        out.append(
            f"  {name:<34s} {e['dispatches']:>7d} {e['compiles']:>8d} "
            f"{e['compile_ms']:>10.1f} {e['cache_hits']:>5d}  "
            f"{'yes' if e['registered'] else 'NO'}"
        )
        cost = e.get("cost")
        if cost and (cost.get("flops") or cost.get("bytes_accessed")):
            out.append(
                "  {:<34s} flops={} bytes={}".format(
                    "", cost.get("flops"), cost.get("bytes_accessed")
                )
            )
    out.append("")
    out.append("  causes:")
    for cause in CAUSES:
        if causes.get(cause):
            out.append(f"    {cause:<20s} {causes[cause]:>6d}")
    offenders = sorted(
        (
            (name, e["compiles"])
            for name, e in entries.items()
            if e["compiles"] > 1
        ),
        key=lambda kv: (-kv[1], kv[0]),
    )[: max(0, top)]
    if offenders:
        out.append("")
        out.append(f"  top recompile offenders (compiles > 1, top {top}):")
        for name, n in offenders:
            out.append(f"    {name:<34s} {n:>6d}")
    storms = [e for e in dump.get("events", []) if e.get("storm")]
    if storms:
        out.append("")
        out.append(f"  storm-flagged events: {len(storms)}")
        for ev in storms[: max(0, top)]:
            out.append(
                f"    seq={ev['seq']} {ev['entry']} cause={ev['cause']} "
                f"static=[{ev['static']}]"
            )
    return "\n".join(out) + "\n"
