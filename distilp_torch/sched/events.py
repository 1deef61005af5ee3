"""Typed fleet-churn events and the JSONL trace wire format.

An event is one line of JSON with a ``kind`` discriminator; a trace is a
file of them, applied in order. Two classes matter to the scheduler:

- **structural** events (``join``/``leave``/``model_swap``) change the
  fleet or model *identity* — the placement problem's shape — and route to
  a (possibly pool-warmed) re-solve under a new warm-pool key;
- **drift** events (``degrade``/``load``) perturb coefficients of the SAME
  problem shape — t_comm, link bandwidth, memory headroom, expert loads —
  and ride warm (dense) or margin (MoE) ticks on the pooled replanner.

The split mirrors what the solver itself distinguishes: a shape change
invalidates the warm incumbent (``StreamingReplanner`` re-solves cold),
pure coefficient drift is exactly what warm re-pricing and the margin fast
path were built for (see ``solver.streaming``).
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Annotated, Dict, List, Literal, Optional, Sequence, Union

from pydantic import BaseModel, Field, TypeAdapter

from ..common import DeviceProfile, ModelProfile

STRUCTURAL_KINDS = frozenset({"join", "leave", "model_swap"})
DRIFT_KINDS = frozenset({"degrade", "load"})


class DeviceJoin(BaseModel):
    """A device enters the fleet (carries its full measured profile)."""

    kind: Literal["join"] = "join"
    t: float = 0.0  # trace time, seconds (monotone but not wall-clock)
    device: DeviceProfile


class DeviceLeave(BaseModel):
    """A device drops out of the fleet, by name."""

    kind: Literal["leave"] = "leave"
    t: float = 0.0
    name: str


class DeviceDegrade(BaseModel):
    """Coefficient drift on one device: link and/or memory degradation.

    Multiplicative, so repeated events compound — a gradual-decay scenario
    is a stream of small ``t_comm_scale > 1`` degrades. ``mem_scale``
    shrinks (or restores) every memory pool the device advertises; for a
    MoE fleet that breaks the margin fast path's exact-match gate, forcing
    a full bound re-evaluation — i.e. a re-certification — by design.
    """

    kind: Literal["degrade"] = "degrade"
    t: float = 0.0
    name: str
    t_comm_scale: float = 1.0  # multiplies t_comm (per-round link time)
    bandwidth_scale: float = 1.0  # multiplies comm_bandwidth (bytes/s)
    mem_scale: float = 1.0  # multiplies d_avail_ram / d_avail_{cuda,metal,tpu}


class ModelSwap(BaseModel):
    """The served model changes (carries the full new profile)."""

    kind: Literal["model_swap"] = "model_swap"
    t: float = 0.0
    model: ModelProfile


class LoadTick(BaseModel):
    """Periodic load refresh: router statistics and/or per-device jitter.

    ``expert_loads`` replaces the model's measured expert popularity (MoE
    profiles; ignored by dense models). ``t_comm_jitter`` multiplies the
    named devices' t_comm — the "load changed the network" channel that
    keeps dense ticks honest too.
    """

    kind: Literal["load"] = "load"
    t: float = 0.0
    expert_loads: Optional[List[float]] = None
    t_comm_jitter: Dict[str, float] = Field(default_factory=dict)


FleetEvent = Annotated[
    Union[DeviceJoin, DeviceLeave, DeviceDegrade, ModelSwap, LoadTick],
    Field(discriminator="kind"),
]

_EVENT_ADAPTER: TypeAdapter = TypeAdapter(FleetEvent)


def is_structural(event) -> bool:
    """Whether the event changes the placement problem's shape/identity."""
    return event.kind in STRUCTURAL_KINDS


def event_from_dict(data: dict):
    """Validate one wire dict into its typed event (discriminated on kind)."""
    return _EVENT_ADAPTER.validate_python(data)


def write_trace(path: str | Path, events: Sequence) -> None:
    """Write events as JSONL, one compact object per line."""
    with open(path, "w") as f:
        for ev in events:
            # exclude_defaults keeps profile-heavy events readable; the
            # discriminator must survive it (it IS a default) or the line
            # cannot be re-validated.
            data = ev.model_dump(exclude_defaults=True)
            data["kind"] = ev.kind
            f.write(json.dumps(data) + "\n")


def read_trace(path: str | Path) -> List:
    """Load a JSONL trace back into typed events (blank lines skipped)."""
    events = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                events.append(event_from_dict(json.loads(line)))
    return events


# -- input validation: the quarantine gate ---------------------------------
#
# Pydantic accepts float('nan')/inf in float fields, so a NaN-poisoned
# profile or a contradictory scale survives schema validation and would
# reach the solver's coefficient builders, where one non-finite entry
# poisons every bound in the sweep. The scheduler calls validate_event()
# on every event BEFORE mutating its fleet; a non-None return quarantines
# the event (counted, recorded, fleet untouched).


def non_finite_path(value, path: str = "") -> Optional[str]:
    """Dotted path of the first non-finite float inside a dumped payload.

    Walks dicts/lists/tuples of plain JSON-able values (the shape
    ``model_dump()`` produces); bools are ints in Python and always fine.
    """
    if isinstance(value, bool):
        return None
    if isinstance(value, (int, float)):
        if not math.isfinite(value):
            return path or "<value>"
        return None
    if isinstance(value, dict):
        for k, v in value.items():
            hit = non_finite_path(v, f"{path}.{k}" if path else str(k))
            if hit is not None:
                return hit
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            hit = non_finite_path(v, f"{path}[{i}]")
            if hit is not None:
                return hit
    return None


def validate_event(event) -> Optional[str]:
    """Reason this event must be quarantined, or None when it is sane.

    Catches what the pydantic schema cannot: non-finite floats anywhere in
    the payload and contradictory values (non-positive multiplicative
    scales, empty/degenerate load vectors). Structural contradictions
    against the LIVE fleet (leave of an unknown device, duplicate join)
    are ``FleetState.apply``'s job — it raises, and the scheduler treats
    that raise as a quarantine too.
    """
    if isinstance(event, DeviceDegrade):
        for fld in ("t_comm_scale", "bandwidth_scale", "mem_scale"):
            v = getattr(event, fld)
            if not math.isfinite(v):
                return f"degrade.{fld} is non-finite ({v!r})"
            if v <= 0 and fld != "mem_scale":
                return f"degrade.{fld} must be > 0 (got {v!r})"
        if event.mem_scale < 0:
            return f"degrade.mem_scale must be >= 0 (got {event.mem_scale!r})"
    elif isinstance(event, LoadTick):
        for name, f in event.t_comm_jitter.items():
            if not math.isfinite(f) or f <= 0:
                return f"load.t_comm_jitter[{name!r}] invalid ({f!r})"
        if event.expert_loads is not None:
            if not event.expert_loads:
                return "load.expert_loads is empty"
            for i, v in enumerate(event.expert_loads):
                if not math.isfinite(v) or v < 0:
                    return f"load.expert_loads[{i}] invalid ({v!r})"
            if sum(event.expert_loads) <= 0:
                return "load.expert_loads sums to zero"
    elif isinstance(event, DeviceJoin):
        if not event.device.name:
            return "join carries an unnamed device"
        hit = non_finite_path(event.device.model_dump())
        if hit is not None:
            return f"join.device.{hit} is non-finite"
    elif isinstance(event, ModelSwap):
        if event.model.L <= 0:
            return f"model_swap.model.L must be > 0 (got {event.model.L})"
        hit = non_finite_path(event.model.model_dump())
        if hit is not None:
            return f"model_swap.model.{hit} is non-finite"
    elif isinstance(event, DeviceLeave):
        if not event.name:
            return "leave names no device"
    return None
