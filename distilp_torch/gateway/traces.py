"""Multi-fleet JSONL traces: the gateway's replayable wire format.

The port's copy of ``distilp_tpu/gateway/traces.py``.

The single-fleet trace (``sched.events``) is one event per line; a
gateway trace tags each line with the fleet it belongs to, and declares
each fleet before its first event:

    {"fleet": "f000", "synthetic": {"m": 3, "seed": 101}}
    {"fleet": "f000", "event": {"kind": "load", "t_comm_jitter": {...}}}
    {"fleet": "f001", "synthetic": {"m": 4, "seed": 102}}
    ...

A ``synthetic`` spec line builds the fleet deterministically from
``utils.make_synthetic_fleet`` (names prefixed with the fleet id so two
fleets never alias devices); the served model comes from the caller (the
serve CLI's ``--profile`` folder), so the trace file stays small and
model-agnostic. Event order across fleets IS the file order — a replay
that honors it is reproducible, and per-fleet order is what shard
serialization guarantees under concurrent ingest.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from ..sched.events import event_from_dict


def is_gateway_trace(path) -> bool:
    """Whether the JSONL file is fleet-tagged (vs a single-fleet trace)."""
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    return "fleet" in json.loads(line)
                except ValueError:  # dlint: disable=DLP017 format probe: a non-JSON line means "not a gateway trace", not a fault
                    return False
    return False


def make_fleet_from_spec(fleet_id: str, spec: dict):
    """Deterministic devices for a ``synthetic`` spec line."""
    from ..utils import make_synthetic_fleet

    m = int(spec.get("m", 3))
    seed = int(spec.get("seed", 0))
    pool_bytes = int(spec.get("pool_bytes", 0))
    devices = make_synthetic_fleet(m, seed=seed, pool_bytes=pool_bytes)
    for d in devices:
        d.name = f"{fleet_id}-{d.name}"
    return devices


def read_gateway_trace(path) -> Tuple[Dict[str, dict], List[Tuple[str, object]]]:
    """(fleet specs, [(fleet_id, event), ...]) in file order.

    Raises on an event line for an undeclared fleet — a trace that relies
    on registration happening elsewhere is not replayable on its own.
    """
    specs: Dict[str, dict] = {}
    items: List[Tuple[str, object]] = []
    with open(path, "r") as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            data = json.loads(line)
            fleet_id = data.get("fleet")
            if not fleet_id:
                raise ValueError(
                    f"{path}:{lineno}: gateway trace line without a fleet tag"
                )
            if "synthetic" in data:
                specs[fleet_id] = dict(data["synthetic"])
            elif "event" in data:
                if fleet_id not in specs:
                    raise ValueError(
                        f"{path}:{lineno}: event for undeclared fleet "
                        f"{fleet_id!r} (no synthetic spec line before it)"
                    )
                items.append((fleet_id, event_from_dict(data["event"])))
            else:
                raise ValueError(
                    f"{path}:{lineno}: gateway trace line needs a "
                    "'synthetic' spec or an 'event'"
                )
    return specs, items


def write_gateway_trace(
    path,
    specs: Dict[str, dict],
    items: Sequence[Tuple[str, object]],
) -> None:
    """Write a gateway trace; spec lines first (stable, replay-friendly)."""
    with open(Path(path), "w") as f:
        for fleet_id, spec in specs.items():
            f.write(json.dumps({"fleet": fleet_id, "synthetic": spec}) + "\n")
        for fleet_id, ev in items:
            data = ev.model_dump(exclude_defaults=True)
            data["kind"] = ev.kind
            f.write(json.dumps({"fleet": fleet_id, "event": data}) + "\n")
