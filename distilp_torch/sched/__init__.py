"""Fleet scheduler service: the solver library run as a long-lived daemon.

``distilp_torch.solver`` answers "where do the layers/experts go, right now?"
one call at a time; nothing owns a fleet over time. This package does:

- ``events``    — typed device-churn events + the JSONL trace format;
- ``fleet``     — the mutable fleet snapshot events apply to;
- ``scheduler`` — the replanning core: one warm ``StreamingReplanner`` per
  (fleet, model) identity in a bounded LRU pool, drift events riding warm/
  margin ticks, structural events re-solving (warm when the identity was
  seen before, cold otherwise), latest certified placement always served;
- ``metrics``   — per-tick counters + latency histograms as a plain dict,
  plus the health-state vocabulary (healthy/degraded/broken);
- ``sim``       — deterministic churn scenario generator + trace replay;
- ``faults``    — seeded fault injection (solver exceptions, latency
  spikes, NaN poisoning, malformed events, dropout bursts) and the
  chaos-replay soak that certifies the degraded-serving path.

The design target is the restarted-PDHG observation (arXiv:2407.16144)
packaged as infrastructure (arXiv:2412.09734): repeated nearby solves
should keep their warm state alive across invocations, which only a
long-lived process can do.

The port's copy of ``distilp_tpu/sched`` (same public names): every solve
runs on the port's engine, on ``device`` (None = cuda, raising without a
GPU; ``'cpu'`` = the kernels' plain versions).
"""

from .faults import (
    FAULT_KINDS,
    ChaosReport,
    FaultInjector,
    FaultPlan,
    FaultSpec,
    InjectedSolverFault,
    chaos_replay,
)
from .events import (
    DRIFT_KINDS,
    STRUCTURAL_KINDS,
    DeviceDegrade,
    DeviceJoin,
    DeviceLeave,
    FleetEvent,
    LoadTick,
    ModelSwap,
    event_from_dict,
    is_structural,
    read_trace,
    write_trace,
)
from .fleet import FleetState
from .forecast import ChurnForecaster
from .metrics import (
    HEALTH_BROKEN,
    HEALTH_DEGRADED,
    HEALTH_HEALTHY,
    HEALTH_STATES,
    METRIC_FAMILIES,
    METRIC_REGISTRY,
    LatencyHist,
    SchedulerMetrics,
    registry_help,
)
from .scheduler import PlacementView, Scheduler, WarmPool, drift_warm_share
from .sim import ReplayReport, generate_trace, replay
from .speculate import (
    BankEntry,
    SpeculationBank,
    bucket_vector,
    candidate_digest,
    instance_digest,
)

__all__ = [
    "DeviceJoin",
    "DeviceLeave",
    "DeviceDegrade",
    "ModelSwap",
    "LoadTick",
    "FleetEvent",
    "STRUCTURAL_KINDS",
    "DRIFT_KINDS",
    "is_structural",
    "event_from_dict",
    "read_trace",
    "write_trace",
    "FleetState",
    "SchedulerMetrics",
    "LatencyHist",
    "METRIC_REGISTRY",
    "METRIC_FAMILIES",
    "registry_help",
    "HEALTH_HEALTHY",
    "HEALTH_DEGRADED",
    "HEALTH_BROKEN",
    "HEALTH_STATES",
    "Scheduler",
    "WarmPool",
    "drift_warm_share",
    "PlacementView",
    "ReplayReport",
    "generate_trace",
    "replay",
    "FAULT_KINDS",
    "FaultSpec",
    "FaultPlan",
    "FaultInjector",
    "InjectedSolverFault",
    "ChaosReport",
    "chaos_replay",
    "ChurnForecaster",
    "SpeculationBank",
    "BankEntry",
    "instance_digest",
    "candidate_digest",
    "bucket_vector",
]
