"""Runtime lock sanitizer: the dynamic half of dlint's DLP032.

``make_lock(name, kind)`` is the one factory the gateway/sched/obs stack
uses for every lock that participates in cross-thread protocols. With
``DLP_LOCKWATCH`` unset (the default, and the production path) it returns
the plain ``threading`` primitive — zero wrappers, zero overhead. With
``DLP_LOCKWATCH=1`` it returns an instrumented wrapper that records, per
thread, the stack of held locks and every *acquisition-order edge* ("B
acquired while A held"), and checks each new edge against the
already-observed graph: a new edge that closes a cycle is a lock-order
violation witness — the exact interleaving dlint's static DLP032 rule
predicts deadlocks from, caught in a real execution.

The observed graph is the runtime's answer to the static one:
``python -m tools.dlint --check-lockwatch out.json`` asserts that every
observed edge appears in the static acquisition graph (the analyzer saw
every real nesting) and that zero cycle witnesses fired. The smoke
target ``make smoke-lockwatch`` runs the gateway overload drill under
the sanitizer and applies exactly that check.

Names are type-granular (every ``LatencyHist`` shares ``metrics.hist``),
matching the static graph's node identity, so the two compare edge for
edge. The cost of that choice: a cycle witness between two *instances*
of one class is indistinguishable from a self-deadlock — same as the
static rule, which hedges the same way.

Env contract:

- ``DLP_LOCKWATCH=1``     — instrument locks created by ``make_lock``.
- ``DLP_LOCKWATCH_OUT``   — write the JSON report here at process exit.
- ``DLP_LOCKWATCH_DIR``   — dump cycle witnesses through the flight
  recorder's post-mortem machinery into this directory.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "make_lock",
    "enabled",
    "report",
    "reset",
    "WatchedLock",
    "WatchedCondition",
]


def enabled() -> bool:
    return os.environ.get("DLP_LOCKWATCH") == "1"


class _PerThread(threading.local):
    def __init__(self):
        self.held: List[str] = []   # acquisition order, innermost last
        self.in_hook: bool = False  # reentrancy guard: the witness dump
        #                             path may itself take watched locks


_tls = _PerThread()


class _Graph:
    """The process-wide observed graph. Its own mutex is a RAW
    threading.Lock — never watched, never part of any recorded edge."""

    def __init__(self):
        self.mu = threading.Lock()
        self.locks: Set[str] = set()
        self.edges: Dict[Tuple[str, str], int] = {}
        self.adj: Dict[str, Set[str]] = {}
        self.witnesses: List[dict] = []


_GRAPH = _Graph()
_MAX_WITNESSES = 64


def _find_path(adj: Dict[str, Set[str]], start: str, goal: str) -> Optional[List[str]]:
    """A path start -> ... -> goal in the observed graph (DFS), or None."""
    stack = [(start, [start])]
    seen = {start}
    while stack:
        node, path = stack.pop()
        for nxt in sorted(adj.get(node, ())):
            if nxt == goal:
                return path + [goal]
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquire(name: str) -> None:
    """Record edges held -> name, then push name onto this thread's held
    stack. Bookkeeping (not the lock itself) is skipped while the witness
    dump path runs — its own lock acquisitions must not recurse here."""
    if not _tls.in_hook:
        _tls.in_hook = True
        try:
            witness = None
            with _GRAPH.mu:
                _GRAPH.locks.add(name)
                for h in _tls.held:
                    if h == name:
                        continue
                    edge = (h, name)
                    count = _GRAPH.edges.get(edge, 0)
                    _GRAPH.edges[edge] = count + 1
                    if count == 0:
                        # New edge: does name already reach h? Then
                        # h -> name closes a cycle.
                        back = _find_path(_GRAPH.adj, name, h)
                        _GRAPH.adj.setdefault(h, set()).add(name)
                        if back is not None and len(_GRAPH.witnesses) < _MAX_WITNESSES:
                            witness = {
                                "kind": "lock-order-cycle",
                                "edge": [h, name],
                                "cycle": [h] + back,
                                "held": list(_tls.held),
                                "thread": threading.current_thread().name,
                            }
                            _GRAPH.witnesses.append(witness)
            if witness is not None:
                _dump_witness(witness)
        finally:
            _tls.in_hook = False
    _tls.held.append(name)


def _note_release(name: str) -> None:
    held = _tls.held
    for i in range(len(held) - 1, -1, -1):
        if held[i] == name:
            del held[i]
            return


_FLIGHT = None


def _dump_witness(witness: dict) -> None:
    """Ship a cycle witness through the flight recorder (post-mortem
    rings + on-disk dump when ``DLP_LOCKWATCH_DIR`` is set). Runs with
    the reentrancy guard up: any watched lock the recorder takes is left
    out of the observed graph."""
    global _FLIGHT
    try:
        from ..obs.flight import FlightRecorder  # lazy: avoid import cycle

        if _FLIGHT is None:
            _FLIGHT = FlightRecorder(
                capacity=_MAX_WITNESSES,
                dump_dir=os.environ.get("DLP_LOCKWATCH_DIR") or None,
            )
        _FLIGHT.record("lockwatch", witness)
        _FLIGHT.trigger("lockwatch", "lock-order-cycle", witness)
    except Exception:
        pass  # the sanitizer must never take the process down


class WatchedLock:
    """Instrumented Lock/RLock: delegates to the real primitive, records
    held-set and acquisition-order edges around it."""

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner

    def acquire(self, *args, **kwargs) -> bool:
        ok = self._inner.acquire(*args, **kwargs)
        if ok:
            _note_acquire(self.name)
        return ok

    def release(self) -> None:
        self._inner.release()
        _note_release(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r} over {self._inner!r}>"


class WatchedCondition(WatchedLock):
    """Instrumented Condition. ``wait`` RELEASES the underlying lock, so
    the held stack pops for the duration and re-pushes on wakeup — a
    nested acquisition during someone else's wait must not look like an
    ordering edge through this condition."""

    def wait(self, timeout: Optional[float] = None):
        _note_release(self.name)
        try:
            return self._inner.wait(timeout)
        finally:
            _note_acquire(self.name)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        _note_release(self.name)
        try:
            return self._inner.wait_for(predicate, timeout)
        finally:
            _note_acquire(self.name)

    def notify(self, n: int = 1) -> None:
        self._inner.notify(n)

    def notify_all(self) -> None:
        self._inner.notify_all()


_KINDS = {
    "lock": threading.Lock,
    "rlock": threading.RLock,
    "condition": threading.Condition,
}


def make_lock(name: str, kind: str = "lock"):
    """THE lock factory for cross-thread protocols.

    ``name`` is the lock's node id in both the static (dlint DLP032) and
    observed (this module) acquisition graphs — dlint reads the literal
    out of the call site, so it must be a string literal. Returns the
    plain ``threading`` primitive unless ``DLP_LOCKWATCH=1``.
    """
    inner = _KINDS[kind]()
    if not enabled():
        return inner
    if kind == "condition":
        return WatchedCondition(name, inner)
    return WatchedLock(name, inner)


def report() -> dict:
    """The observed graph as a JSON-able dict (what
    ``DLP_LOCKWATCH_OUT`` receives at exit, and what
    ``python -m tools.dlint --check-lockwatch`` validates)."""
    with _GRAPH.mu:
        return {
            "enabled": enabled(),
            "locks": sorted(_GRAPH.locks),
            "edges": [
                {"from": a, "to": b, "count": c}
                for (a, b), c in sorted(_GRAPH.edges.items())
            ],
            "witnesses": list(_GRAPH.witnesses),
        }


def reset() -> None:
    """Clear the observed graph (test isolation)."""
    with _GRAPH.mu:
        _GRAPH.locks.clear()
        _GRAPH.edges.clear()
        _GRAPH.adj.clear()
        _GRAPH.witnesses.clear()


@atexit.register
def _write_report_at_exit() -> None:
    out = os.environ.get("DLP_LOCKWATCH_OUT")
    if not out or not enabled():
        return
    try:
        with open(out, "w") as fh:
            json.dump(report(), fh, indent=2, sort_keys=True)
            fh.write("\n")
    except OSError:
        pass
