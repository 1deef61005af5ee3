"""Consistent-hash shard routing: (fleet, model) -> exactly one worker.

The port's copy of ``distilp_tpu/gateway/router.py`` (same ring, same
owners).

Every shard must be owned by exactly one solve worker — two workers
ticking the same shard would interleave warm-state writes — and the
mapping must be stable under reconfiguration: a snapshot taken under 2
workers restored under 4 should move as few shards as possible (a moved
shard keeps its warm state — it rides the snapshot blob — but its new
worker solves it on graph plans of its own). A classic consistent-hash ring over virtual nodes
gives both: deterministic ownership (pure function of the shard key and
the worker count — a restored gateway recomputes the same routing), and
~1/N churn when N changes.

No coordination, no clock, no randomness: the ring is SHA-1 positions of
``worker:<i>#<v>`` labels, so two processes with the same worker count
route identically — which is what lets the load generator and the serve
CLI reason about per-worker load without talking to each other.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional, Sequence, Tuple


def _ring_hash(label: str) -> int:
    """64-bit ring position (SHA-1 prefix; stable across processes —
    Python's builtin ``hash`` is salted per process and would not be)."""
    return int.from_bytes(hashlib.sha1(label.encode()).digest()[:8], "big")


class ConsistentHashRouter:
    """Stable shard->worker assignment over a virtual-node hash ring.

    ``worker_ids`` generalizes the ring to a sparse id set for the
    autoscaler: retiring worker 1 of {0, 1, 2} leaves ids {0, 2} on the
    ring, and only worker 1's slices move (~1/N churn, same property as
    growing N). When ``worker_ids`` is exactly ``range(n_workers)`` the
    ring is label-for-label identical to the fixed-count form, so
    snapshot/restore routing semantics are unchanged.
    """

    def __init__(
        self,
        n_workers: Optional[int] = None,
        replicas: int = 64,
        worker_ids: Optional[Sequence[int]] = None,
    ):
        if worker_ids is None:
            if n_workers is None:
                raise ValueError("router needs n_workers or worker_ids")
            worker_ids = range(n_workers)
        ids = sorted(set(int(w) for w in worker_ids))
        if len(ids) < 1:
            raise ValueError("router needs at least one worker")
        if replicas < 1:
            raise ValueError("router needs at least one virtual node")
        self.worker_ids = ids
        self.n_workers = len(ids)
        self.replicas = replicas
        ring: List[Tuple[int, int]] = []
        for w in ids:
            for v in range(replicas):
                ring.append((_ring_hash(f"worker:{w}#{v}"), w))
        ring.sort()
        self._ring = ring
        self._points = [h for h, _ in ring]

    def owner(self, shard_key: str) -> int:
        """Worker index owning this shard (first ring point clockwise)."""
        h = _ring_hash(shard_key)
        idx = bisect.bisect_right(self._points, h)
        if idx == len(self._ring):
            idx = 0
        return self._ring[idx][1]

    def assignments(self, shard_keys: Sequence[str]) -> Dict[str, int]:
        return {k: self.owner(k) for k in shard_keys}

    def load(self, shard_keys: Sequence[str]) -> List[int]:
        """Shards per worker — the balance gauge the bench reports.

        Positionally aligned with ``worker_ids`` (identical to the old
        index-aligned list when ids are dense from zero).
        """
        slot = {w: i for i, w in enumerate(self.worker_ids)}
        counts = [0] * self.n_workers
        for k in shard_keys:
            counts[slot[self.owner(k)]] += 1
        return counts


def shard_key(fleet_id: str, model_id: str = "default") -> str:
    """The canonical shard name. '/' is reserved for the HTTP path split."""
    if not fleet_id or "/" in fleet_id or "/" in model_id:
        raise ValueError(
            f"fleet/model ids must be non-empty and '/'-free "
            f"(got fleet={fleet_id!r}, model={model_id!r})"
        )
    return f"{fleet_id}::{model_id}"
