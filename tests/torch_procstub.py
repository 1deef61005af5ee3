"""A picklable-by-spec scheduler stub for the port's process-worker tests.

The port's copy of ``tests/procstub.py``, free of JAX: it imports the
port's ``SchedulerMetrics``.

The child process resolves ``tests.torch_procstub:make_scheduler`` (a
'module:callable' factory spec — the only factory form that crosses a
process boundary) and hosts ``StubScheduler`` instances: no
solver, just the scheduler surface the gateway's closures touch, with
every return value a plain picklable dict. The warm-resume audit
counters mirror the real scheduler's restore contract closely enough
for the migration reconciliation tests to pin warm_resumes/cold_resumes
through a live move.
"""

from __future__ import annotations

import os
import time

from distilp_torch.sched.metrics import SchedulerMetrics


class StubScheduler:
    def __init__(self, devices, model):
        self.devices = list(devices)
        self.model = model
        self.metrics = SchedulerMetrics()
        self.health = "healthy"
        self.spec_k = 4
        self.events = 0
        self._restore_pending = False
        # Chaos knobs (crash-taxonomy tests), set over the RPC
        # setattr surface and inert by default. Neither rides the dump
        # blob: a respawned child comes back with both disarmed, exactly
        # like a real scheduler loses its injected faults on restart.
        self.exit_on_dump = 0  # die (os._exit) on the Nth dump_state call
        self.solve_sleep_s = 0.0  # stretch handle() so a kill lands mid-solve
        self.dumps = 0

    # -- ticks -------------------------------------------------------------

    def handle(self, event, pressure: bool = False):
        if self.solve_sleep_s:
            time.sleep(self.solve_sleep_s)
        if self._restore_pending:
            self._restore_pending = False
            self.metrics.inc("warm_resumes")
        self.events += 1
        self.metrics.inc("events_total")
        return {
            "seq": self.events,
            "pressure": bool(pressure),
            "kind": getattr(event, "kind", str(event)),
        }

    def handle_coalesced(self, events, pressure: bool = False):
        out = None
        for ev in events:
            out = self.handle(ev, pressure=pressure)
        return out

    def latest(self):
        return {"seq": self.events} if self.events else None

    # -- snapshot chain ----------------------------------------------------

    def dump_state(self) -> dict:
        self.dumps += 1
        if self.exit_on_dump and self.dumps >= self.exit_on_dump:
            # Child suicide mid-RPC: the parent's recv sees EOF and
            # raises WorkerCrashed — the migration-abort / torn-dump
            # corner the fold-on-abort tests pin.
            os._exit(43)
        return {
            "version": 1,
            "devices": list(self.devices),
            "model": self.model,
            "events": self.events,
            "spec_k": self.spec_k,
        }

    def load_state(self, state: dict) -> None:
        self.events = state["events"]
        self.spec_k = state.get("spec_k", self.spec_k)
        self._restore_pending = True
        self.metrics.inc("state_restored")

    # -- reads -------------------------------------------------------------

    def health_snapshot(self) -> dict:
        return {"state": self.health, "breaker_open": False}

    def metrics_snapshot(self) -> dict:
        return self.metrics.snapshot()

    def close(self) -> None:
        self.health = "closed"


def make_scheduler(devices, model) -> StubScheduler:
    return StubScheduler(devices, model)
