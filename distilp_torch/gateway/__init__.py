"""Gateway: the horizontally scalable multi-fleet serving tier.

The port's copy of ``distilp_tpu/gateway`` (same public names).
``distilp_torch.sched`` turned the solver into ONE fleet's long-lived
daemon; this package turns that daemon into a service for MANY fleets:

- ``router``   — consistent-hash shard ownership: each (fleet, model)
  shard belongs to exactly one solve worker, deterministically, with
  ~1/N churn when the worker count changes;
- ``worker``   — the solve worker: one thread, N shards, every shard's
  ``Scheduler`` run unchanged (quarantine/deadline/breaker/HealthState
  per shard, isolated);
- ``gateway``  — the tier itself: sync + asyncio ingest, per-shard
  routing, admission control and coalescing, the cross-shard combiner
  (``distilp_torch.combine``), aggregated health/metrics, drain + warm
  snapshot, supervised crash recovery;
- ``snapshot`` — ``GatewaySnapshot``: every shard's warm state (fleet,
  incumbents, duals, IPM/PDHG iterates, margin anchors, health) as one
  JSON file; restore resumes with warm ticks, zero cold re-solves;
- ``http``     — minimal stdlib HTTP/1.1 JSON API (POST /events,
  GET /placement/<fleet>, /healthz, /metrics);
- ``traces``   — fleet-tagged JSONL traces (the multi-fleet replay
  format) and deterministic synthetic-fleet specs;
- ``loadgen``  — the closed-loop throughput harness (K fleets × N
  workers, events/sec + latency quantiles);
- ``procworker`` — process-backed workers: the same ShardWorker
  contract with the schedulers hosted in a dedicated subprocess (own
  GIL, own CUDA context) behind a length-prefixed unix-socket RPC.

Every shard solves on the gateway's device: the card unless the caller
passes ``device='cpu'``.
"""

from .gateway import (
    FleetReadView,
    Gateway,
    QueueFull,
    ShardFacade,
    view_to_dict,
)
from .http import GatewayHTTPServer
from .loadgen import run_loadgen
from .router import ConsistentHashRouter, shard_key
from .snapshot import (
    GatewaySnapshot,
    ShardSnapshot,
    load_snapshot,
    save_snapshot,
    snapshot_path,
)
from .traces import (
    is_gateway_trace,
    make_fleet_from_spec,
    read_gateway_trace,
    write_gateway_trace,
)
from .worker import ShardWorker, WorkerQueueFull


def __getattr__(name):
    # Lazy on purpose: the worker CHILD process runs `python -m
    # distilp_torch.gateway.procworker`, which imports this package first;
    # an eager `from .procworker import …` here would double-import the
    # child's own entry module (runpy's sys.modules warning).
    if name in ("ProcShardWorker", "SchedulerProxy"):
        from . import procworker

        return getattr(procworker, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "Gateway",
    "QueueFull",
    "FleetReadView",
    "WorkerQueueFull",
    "ShardFacade",
    "view_to_dict",
    "GatewayHTTPServer",
    "run_loadgen",
    "ConsistentHashRouter",
    "shard_key",
    "GatewaySnapshot",
    "ShardSnapshot",
    "load_snapshot",
    "save_snapshot",
    "snapshot_path",
    "is_gateway_trace",
    "make_fleet_from_spec",
    "read_gateway_trace",
    "write_gateway_trace",
    "ShardWorker",
    "ProcShardWorker",
    "SchedulerProxy",
]
