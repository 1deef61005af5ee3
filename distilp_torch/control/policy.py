"""The declarative autoscaling policy + the typed action vocabulary.

Same spirit as the SLO alert ladder: a committed JSON document, not
code, decides when the fleet moves. The policy is target bands plus the
two stabilizers every production autoscaler needs — **hysteresis**
(scale-out trips on any one vote the moment it fires; scale-in needs
EVERY calm condition to hold for ``calm_hold_s`` straight) and a
**cooldown** (at most one scale action per ``scale_cooldown_s``, so a
burst cannot ping-pong the fleet). Actions are a closed, versioned
vocabulary: the flight trail, the offline replay fixture and the live
actuator all speak exactly these shapes, so a decision recorded live
can be diffed byte-for-byte against its offline reproduction.
"""

from __future__ import annotations

import json
from typing import List, Literal, Optional

from pydantic import BaseModel, ConfigDict, Field


class Action(BaseModel):
    """One controller decision, exactly as flight-recorded.

    kind            lever
    --------------  -----------------------------------------------
    ``scale_out``   spawn one worker; ring rebalance migrates shards
    ``scale_in``    retire one worker; its slices migrate off first
    ``degrade_on``  force PRESSURE serving (spec_near admission)
    ``degrade_off`` restore the static admission verdict
    ``spec_k``      set the speculation bank width on every shard
    """

    model_config = ConfigDict(extra="forbid")

    version: Literal[1] = 1
    t: float
    kind: Literal[
        "scale_out", "scale_in", "degrade_on", "degrade_off", "spec_k"
    ]
    target_workers: Optional[int] = None
    spec_k: Optional[int] = None
    reason: str


class ControlPolicy(BaseModel):
    """Target bands + hysteresis + cooldown, committed as JSON."""

    model_config = ConfigDict(extra="forbid")

    version: Literal[1] = 1
    min_workers: int = Field(1, ge=1)
    max_workers: int = Field(4, ge=1)
    # At most one scale action (either direction) per cooldown window.
    scale_cooldown_s: float = Field(10.0, ge=0.0)

    # -- scale-out votes: ANY one trips (subject to cooldown/max) --------
    # A page-severity SLO alert is the loudest vote.
    scale_out_on_page: bool = True
    # headroom_eps below this fraction of capacity (needs the capacity
    # probe — satellite: auto-populated post-warmup when unset).
    headroom_min_frac: Optional[float] = 0.10
    # Mean queue depth per worker at or above this trips.
    depth_high_per_worker: Optional[float] = 8.0
    # Any worker's depth trend (slope, units/s) at or above this trips.
    trend_up_per_s: Optional[float] = None
    # A NEWLY quarantined worker (crash-loop breaker opened; the signals
    # payload's ``recovery`` block, supervised process tier only) votes
    # scale-out: the ring just lost a slice for good, and respawn cannot
    # win it back. Inert when signals carry no recovery block, so
    # committed replay fixtures from unsupervised captures are unchanged.
    scale_out_on_quarantine: bool = True

    # -- scale-in: ALL calm conditions, sustained --------------------------
    calm_hold_s: float = Field(15.0, ge=0.0)
    depth_low_total: float = 1.0
    headroom_scale_in_frac: float = 0.50

    # -- admission degrade lever ------------------------------------------
    # Instant, reversible: force spec_near serving while a page is open
    # (scale-out takes effect over seconds; degrade takes effect now).
    degrade_on_page: bool = True

    # -- spec_k memory lever ----------------------------------------------
    # When mem_headroom_bytes drops below the floor, shrink the
    # speculation bank to this width; restore when headroom recovers.
    mem_low_bytes: Optional[float] = None
    spec_k_low: int = Field(1, ge=0)
    spec_k_normal: Optional[int] = None

    @classmethod
    def from_json(cls, path) -> "ControlPolicy":
        with open(path) as fh:
            return cls.model_validate(json.load(fh))


def actions_to_jsonl(actions: List[Action]) -> str:
    """One action per line, key-sorted — byte-stable for a given decision
    sequence, so the committed fixture pins ``Controller.replay``
    regeneration exactly (the ``slo_expected_alerts`` convention)."""
    return "".join(
        json.dumps(a.model_dump(), sort_keys=True) + "\n" for a in actions
    )
