"""GatewaySnapshot: the gateway's warm state, serialized for restarts.

The port's copy of ``distilp_tpu/gateway/snapshot.py`` (the same JSON
format; ``interop.gateway_snapshot_from_jax`` carries one of the JAX
package's across).

A drain/restore cycle must resume with warm ticks — zero cold re-solves —
so the snapshot carries, per shard: the fleet snapshot (devices + model +
event seq), the published placement, the health/breaker machine, and the
warm pool's full blob (incumbents, Lagrangian duals, IPM/PDHG root
iterates, MoE margin anchors) via ``Scheduler.dump_state`` →
``StreamingReplanner.dump_warm_state``. Arrays travel as base64 raw
bytes, so the round trip is bit-exact and a restored tick equals the
uninterrupted one.

The snapshot is plain JSON on disk (one file, atomic rename) — restore
does not need the producing process, only a gateway built with the same
solver configuration. Worker count may differ across the cycle: shards
re-route by consistent hash on restore, each carrying its warm state to
its new owner.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List

from pydantic import BaseModel, Field

SNAPSHOT_VERSION = 1
SNAPSHOT_FILENAME = "gateway_snapshot.json"


class ShardSnapshot(BaseModel):
    """One shard's identity + its scheduler's full warm state."""

    fleet_id: str
    model_id: str = "default"
    shard_key: str
    # How many trace events this shard has HANDLED (quarantines included)
    # — the resume cursor a trace replay skips to. ``Scheduler`` state
    # carries the fleet seq (events *applied*); a quarantined event
    # advances handled but not seq, and a resume must not replay it.
    events_handled: int = 0
    # Scheduler.dump_state() blob (JSON-able; arrays base64-encoded).
    state: dict


class GatewaySnapshot(BaseModel):
    """Every shard's warm state + the gateway shape that produced it."""

    version: int = SNAPSHOT_VERSION
    n_workers: int
    shards: List[ShardSnapshot] = Field(default_factory=list)
    # Gateway-level counters at snapshot time (informational only; a
    # restored gateway starts fresh counters — `warm_resumes` on the other
    # side is what audits the cycle).
    counters: Dict[str, int] = Field(default_factory=dict)

    def shard_for(self, fleet_id: str) -> ShardSnapshot:
        for s in self.shards:
            if s.fleet_id == fleet_id:
                return s
        raise KeyError(f"snapshot has no shard for fleet {fleet_id!r}")


def snapshot_path(directory) -> Path:
    return Path(directory) / SNAPSHOT_FILENAME


def _durable_replace(tmp: Path, path: Path) -> None:
    """``os.replace`` with the two fsyncs rename-atomicity forgets.

    ``tmp`` must already hold the complete payload. The file is fsynced
    BEFORE the rename (so the bytes are on the platter when the name
    flips) and the parent directory is fsynced after (so the rename
    itself survives a host crash — without it the directory entry can
    still point at the old inode after power loss, or at nothing).
    Directory fds are unsupported on some filesystems; that fsync is
    best-effort by design, the file fsync is not.
    """
    fd = os.open(tmp, os.O_RDWR)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    os.replace(tmp, path)
    try:
        dfd = os.open(path.parent, os.O_RDONLY)
    except OSError:  # dlint: disable=DLP017 directory fds unsupported on some filesystems; the directory fsync is best-effort by contract (docstring), the file fsync above is not
        return
    try:
        os.fsync(dfd)
    except OSError:  # dlint: disable=DLP017 same best-effort contract: a filesystem that rejects directory fsync still got the file fsync + atomic rename
        pass
    finally:
        os.close(dfd)


def save_snapshot(snap: GatewaySnapshot, directory) -> Path:
    """Write the snapshot atomically (tmp + durable rename) under ``directory``.

    A crash mid-write must leave either the previous snapshot or none —
    never a torn file a restore would half-parse — and a snapshot that
    returned from here must survive a host crash (`_durable_replace`).
    """
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = snapshot_path(directory)
    tmp = path.with_suffix(".json.tmp")
    tmp.write_text(json.dumps(snap.model_dump()))
    _durable_replace(tmp, path)
    return path


def load_snapshot(directory) -> GatewaySnapshot:
    path = snapshot_path(directory)
    if not path.is_file():
        raise FileNotFoundError(f"no gateway snapshot at {path}")
    snap = GatewaySnapshot.model_validate(json.loads(path.read_text()))
    if snap.version != SNAPSHOT_VERSION:
        raise ValueError(
            f"unknown snapshot version {snap.version} "
            f"(this build reads {SNAPSHOT_VERSION})"
        )
    return snap
