"""Flight recorder: a black box for the serving path's last N ticks.

Counters say HOW OFTEN things happen; the chaos soak says WHETHER the
contract held; neither answers the post-mortem question "what exactly were
the last thirty ticks doing when the breaker opened?". The flight recorder
does: every handled event appends one compact record — fleet seq, event
kind, served mode, health, LP engine, the tick's span ids (when tracing is
on) and the COUNTER DELTAS that tick caused — to a per-shard bounded ring.

Two ways out of the ring:

- **live**: ``GET /debug/flight/<fleet>`` on the gateway HTTP API returns
  the shard's current ring (``FlightRecorder.snapshot``), no dump needed;
- **post-mortem**: ``trigger()`` — fired by the scheduler on breaker-open,
  and by the serve CLI on a chaos-contract violation — writes the ring to
  a JSONL file in ``dump_dir`` (header line naming the trigger reason and
  the triggering record, then one line per ring record, oldest first).
  With no ``dump_dir`` the trigger still lands in the ring as a marker
  record, so the live view shows it.

Recording is append-one-dict-per-tick under a lock: workers record
concurrently, HTTP reads land mid-soak, and dumps must see a consistent
ring. Like tracing, the whole thing is opt-in — a scheduler without a
recorder attached runs the exact pre-obs code path.
"""

from __future__ import annotations

import json
import re
import time
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional

from ..utils.lockwatch import make_lock

__all__ = ["FlightRecorder"]

_SAFE_KEY = re.compile(r"[^A-Za-z0-9._-]+")


class FlightRecorder:
    """Bounded per-shard tick-record rings with post-mortem dumps."""

    def __init__(self, capacity: int = 128, dump_dir=None):
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = capacity
        self.dump_dir = Path(dump_dir) if dump_dir is not None else None
        self._rings: Dict[str, deque] = {}  # guarded-by: self._lock
        self._lock = make_lock("flight.ring")
        self._dump_seq = 0  # guarded-by: self._lock
        # Post-mortems written, oldest first.
        self.dumps: List[Path] = []  # guarded-by: self._lock

    def record(self, key: str, rec: dict) -> None:
        """Append one tick record to ``key``'s ring (oldest falls off)."""
        with self._lock:
            ring = self._rings.get(key)
            if ring is None:
                ring = self._rings[key] = deque(maxlen=self.capacity)
            ring.append(rec)

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._rings)

    def snapshot(self, key: str) -> List[dict]:
        """The ring's current contents, oldest first (copy; JSON-able)."""
        with self._lock:
            ring = self._rings.get(key)
            return list(ring) if ring is not None else []

    def trigger(
        self, key: str, reason: str, record: Optional[dict] = None
    ) -> Optional[Path]:
        """A post-mortem moment: dump ``key``'s ring (when a ``dump_dir``
        is configured) and mark the trigger in the ring either way.

        ``record`` is the tick record that tripped the trigger (it carries
        the span ids a post-mortem starts from). Returns the dump path, or
        None when no dump directory is configured.
        """
        with self._lock:
            ring = self._rings.get(key)
            records = list(ring) if ring is not None else []
            marker = {
                "flight_trigger": reason,
                "at": time.time(),
                "record": record,
            }
            if ring is None:
                ring = self._rings[key] = deque(maxlen=self.capacity)
            ring.append(marker)
            if self.dump_dir is None:
                return None
            self._dump_seq += 1
            seq = self._dump_seq
        self.dump_dir.mkdir(parents=True, exist_ok=True)
        safe = _SAFE_KEY.sub("_", key) or "shard"
        path = self.dump_dir / f"postmortem-{safe}-{seq:03d}.jsonl"
        header = {
            "flight": key,
            "reason": reason,
            "dumped_at": time.time(),
            "records": len(records),
            "trigger": record,
        }
        with open(path, "w", encoding="utf-8") as fh:
            fh.write(json.dumps(header, default=str) + "\n")
            for rec in records:
                fh.write(json.dumps(rec, default=str) + "\n")
        with self._lock:
            self.dumps.append(path)
        return path
