"""Crash-tolerance primitives for the process-backed worker tier.

The port's copy of ``distilp_tpu/gateway/recovery.py``.

Three small pieces the gateway's supervisor composes into the
exactly-once recovery contract:

``ShardWAL``
    A per-fleet append-only write-ahead journal. Every ACCEPTED event is
    framed into the journal *before* its RPC dispatches to the child, as
    ``(cursor, event)`` where cursor is the fleet's events-handled count
    after this event applies. Frames are 8-byte big-endian length +
    pickle — the same framing the worker RPC itself speaks — and a torn
    trailing frame (the writer died mid-append) is tolerated on read:
    a half-written record's event never reached the child either, so
    dropping it loses nothing.

``RecoveryStore``
    The on-disk layout: one directory per fleet holding ``wal.bin`` and
    ``micro_snapshot.bin``. Micro-snapshots ride the bit-exact
    ``dump_state``/``load_state`` chain (plus the shard's live counters,
    so cumulative metrics survive the child); they are written via
    :func:`~distilp_torch.gateway.snapshot._durable_replace` (fsync before
    rename + dir fsync) and each successful snapshot truncates the WAL
    to its cursor. WAL appends only flush — the journal defends against
    CHILD death (the parent process, which holds the page cache, is
    alive to replay); the durable rename defends against HOST death.

``Supervisor``
    The respawn policy for one worker: a crash-time deque pruned to a
    sliding window. Each crash classifies to ``respawn`` (with bounded
    exponential backoff, doubling per crash in the window) until N
    crashes land inside the window — then ``quarantine``: the worker is
    taken out of the ring, its slice rebalanced away, and the fact
    surfaced in ``/signals`` for the controller to vote scale-out on.

Single-writer contract: a fleet's WAL and snapshot are only touched from
the worker thread that owns the fleet's shard (tick closures are
serialized per worker, and recovery itself runs inline on that thread),
so these classes carry no locks by design.
"""

from __future__ import annotations

import pickle
import struct
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .snapshot import _durable_replace

WAL_FILENAME = "wal.bin"
MICRO_SNAPSHOT_FILENAME = "micro_snapshot.bin"

_LEN = struct.Struct(">Q")


def _frame(cursor: int, event: Any) -> bytes:
    payload = pickle.dumps((cursor, event), protocol=pickle.HIGHEST_PROTOCOL)
    return _LEN.pack(len(payload)) + payload


class ShardWAL:
    """Append-only ``(cursor, event)`` journal for one fleet's shard."""

    def __init__(self, path) -> None:
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = None

    # -- write side ------------------------------------------------------

    def append(self, cursor: int, event: Any) -> None:
        """Journal one accepted event BEFORE its RPC dispatches."""
        if self._fh is None or self._fh.closed:
            self._fh = open(self.path, "ab")
        self._fh.write(_frame(cursor, event))
        self._fh.flush()

    def truncate_to(self, cursor: int) -> None:
        """Drop every record with ``record.cursor <= cursor`` (snapshot
        boundary). Rewrites via durable replace so a host crash leaves
        either the old journal or the truncated one, never a torn mix."""
        keep = [(c, e) for c, e in self.records() if c > cursor]
        self.close()
        tmp = self.path.with_name(self.path.name + ".tmp")
        with open(tmp, "wb") as fh:
            for c, e in keep:
                fh.write(_frame(c, e))
            fh.flush()
        _durable_replace(tmp, self.path)

    def close(self) -> None:
        if self._fh is not None and not self._fh.closed:
            self._fh.close()
        self._fh = None

    # -- read side -------------------------------------------------------

    def records(self) -> List[Tuple[int, Any]]:
        """All intact records, in append order. A torn trailing frame
        (partial header or payload) ends the scan without raising: the
        half-written event never dispatched, so it is not recovery state."""
        if self._fh is not None and not self._fh.closed:
            self._fh.flush()
        if not self.path.is_file():
            return []
        out: List[Tuple[int, Any]] = []
        raw = self.path.read_bytes()
        off = 0
        while off + _LEN.size <= len(raw):
            (n,) = _LEN.unpack_from(raw, off)
            if off + _LEN.size + n > len(raw):
                break  # torn tail
            out.append(pickle.loads(raw[off + _LEN.size : off + _LEN.size + n]))
            off += _LEN.size + n
        return out

    def tail_after(self, cursor: int) -> List[Tuple[int, Any]]:
        return [(c, e) for c, e in self.records() if c > cursor]


class RecoveryStore:
    """Per-fleet WAL + micro-snapshot layout rooted at one directory."""

    def __init__(self, root) -> None:
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._wals: Dict[str, ShardWAL] = {}

    def _fleet_dir(self, fleet_id: str) -> Path:
        return self.root / fleet_id.replace("/", "_")

    def wal(self, fleet_id: str) -> ShardWAL:
        if fleet_id not in self._wals:
            self._wals[fleet_id] = ShardWAL(self._fleet_dir(fleet_id) / WAL_FILENAME)
        return self._wals[fleet_id]

    def _snap_path(self, fleet_id: str) -> Path:
        return self._fleet_dir(fleet_id) / MICRO_SNAPSHOT_FILENAME

    def save_micro_snapshot(
        self,
        fleet_id: str,
        cursor: int,
        state: dict,
        counters: Optional[Dict[str, int]] = None,
    ) -> None:
        """Durably persist ``dump_state`` at ``cursor``; truncate the WAL.

        The order matters: the snapshot must be on disk (durable rename)
        BEFORE its WAL prefix disappears, so a crash between the two
        steps only leaves redundant journal records — replaying a record
        at-or-below the snapshot cursor is skipped by the cursor compare,
        never double-applied.
        """
        path = self._snap_path(fleet_id)
        path.parent.mkdir(parents=True, exist_ok=True)
        blob = pickle.dumps(
            {"cursor": cursor, "state": state, "counters": dict(counters or {})},
            protocol=pickle.HIGHEST_PROTOCOL,
        )
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_bytes(blob)
        _durable_replace(tmp, path)
        self.wal(fleet_id).truncate_to(cursor)

    def load_micro_snapshot(self, fleet_id: str) -> Optional[dict]:
        path = self._snap_path(fleet_id)
        if not path.is_file():
            return None
        return pickle.loads(path.read_bytes())

    def recovery_plan(self, fleet_id: str) -> Tuple[Optional[dict], List[Tuple[int, Any]]]:
        """(micro-snapshot or None, WAL records strictly after its cursor)."""
        snap = self.load_micro_snapshot(fleet_id)
        cursor = snap["cursor"] if snap is not None else 0
        return snap, self.wal(fleet_id).tail_after(cursor)

    def drop(self, fleet_id: str) -> None:
        """Forget a fleet's recovery state (fleet deregistered)."""
        wal = self._wals.pop(fleet_id, None)
        if wal is not None:
            wal.close()
        d = self._fleet_dir(fleet_id)
        for name in (WAL_FILENAME, MICRO_SNAPSHOT_FILENAME):
            p = d / name
            if p.is_file():
                p.unlink()

    def close(self) -> None:
        for wal in self._wals.values():
            wal.close()
        self._wals.clear()


class Supervisor:
    """Respawn policy for ONE worker: classify each crash, bound the rate.

    ``record_crash()`` returns the verdict — ``"respawn"`` while fewer
    than ``threshold`` crashes landed inside the sliding ``window_s``,
    ``"quarantine"`` at the threshold (the crash-loop breaker opening).
    ``backoff_s()`` is the sleep before the next respawn attempt:
    ``base * 2**(crashes_in_window - 1)`` capped at ``max``.
    """

    def __init__(
        self,
        threshold: int = 3,
        window_s: float = 30.0,
        backoff_base_s: float = 0.05,
        backoff_max_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.threshold = max(1, int(threshold))
        self.window_s = float(window_s)
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self._clock = clock
        self._crashes: Deque[float] = deque()
        self.total_crashes = 0
        self.quarantined = False

    def _prune(self, now: float) -> None:
        while self._crashes and now - self._crashes[0] > self.window_s:
            self._crashes.popleft()

    def record_crash(self) -> str:
        now = self._clock()
        self._prune(now)
        self._crashes.append(now)
        self.total_crashes += 1
        if len(self._crashes) >= self.threshold:
            self.quarantined = True
            return "quarantine"
        return "respawn"

    def backoff_s(self) -> float:
        n = max(1, len(self._crashes))
        return min(self.backoff_base_s * (2 ** (n - 1)), self.backoff_max_s)

    @property
    def crashes_in_window(self) -> int:
        self._prune(self._clock())
        return len(self._crashes)
