"""Multi-fleet JSONL traces: the gateway's replayable wire format.

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

The port's copy holds only ``is_gateway_trace``: the single-fleet ``serve``
refuses such a trace. Reading, writing and replaying one is the gateway
tier's (ROADMAP A12b).
"""

from __future__ import annotations

import json


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
