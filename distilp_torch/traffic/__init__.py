"""Open-loop traffic: seeded arrival processes + the overload harness (the
port's copy of ``distilp_tpu/traffic``).

Every load number before this package came from CLOSED-loop replay
(``gateway.loadgen``): the next event waits for the previous one's
placement, so offered load can never exceed capacity and collapse
behavior is structurally invisible. This package generates load the way
the world does — events fire at their scheduled time whether or not the
service kept up — and measures what the gateway's admission control
(bounded queues, shedding, coalescing, degraded serving) does about it:

- ``arrivals`` — the seeded arrival-process generator: a Poisson base
  rate modulated by a diurnal curve and correlated regional bursts,
  with per-fleet event payloads drawn from the existing churn simulator
  (``sched.sim``); emits fleet-tagged TIMESTAMPED schedules, plus the
  JSONL trace format (``tests/traces/openloop_*.jsonl`` are committed
  seeded captures with byte-exact regeneration tests);
- ``openloop`` — the executor + harness: fire each event at its
  scheduled time (lateness accumulates, the generator never throttles),
  measure scheduled-time latency (p50/p99/p99.9 — what a CLIENT sees,
  queueing included), count sheds/coalesces/degraded serves, and
  reconcile every shed record-by-record against the flight recorder
  (``shed_violations`` — the ChaosReport.violations() contract extended
  to admission control).

Stdlib + numpy + the existing gateway/sched stack; torch and the kernels
load only through the schedulers the gateway builds.
"""

from .arrivals import (
    ArrivalConfig,
    ScheduledEvent,
    generate_openloop_schedule,
    is_openloop_trace,
    read_openloop_trace,
    write_openloop_trace,
)
from .openloop import execute_openloop, run_openloop, shed_violations

__all__ = [
    "ArrivalConfig",
    "ScheduledEvent",
    "generate_openloop_schedule",
    "is_openloop_trace",
    "read_openloop_trace",
    "write_openloop_trace",
    "execute_openloop",
    "run_openloop",
    "shed_violations",
]
