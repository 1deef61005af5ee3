"""Mutable fleet snapshot: the state a scheduler owns and events mutate.

Devices live in an insertion-ordered dict (placement order is device
order — the solver's pipeline rings follow it), the model rides alongside,
and two digests name the CURRENT placement problem's identity:

- ``fleet_digest``  — device names in order (shape identity: who is in the
  ring, in what order). Drift events mutate coefficients, not the digest.
- ``model_digest``  — the model's architecture scalars.

The (fleet_digest, model_digest) pair is the scheduler's warm-pool key: a
fleet+model identity seen before gets its warm ``StreamingReplanner`` back
(stale warm hints are sound — they are re-priced exactly on-device), a new
identity starts cold.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List

from ..common import DeviceProfile, ModelProfile
from .events import (
    DeviceDegrade,
    DeviceJoin,
    DeviceLeave,
    LoadTick,
    ModelSwap,
    is_structural,
)


class FleetState:
    """Ordered device map + current model, with event application."""

    def __init__(self, devices: List[DeviceProfile], model: ModelProfile):
        if not devices:
            raise ValueError("a fleet needs at least one device")
        self.devices: Dict[str, DeviceProfile] = {}
        for d in devices:
            dev = d.model_copy(deep=True)
            if dev.name in self.devices:
                raise ValueError(f"duplicate device name {dev.name!r}")
            self.devices[dev.name] = dev
        self.model: ModelProfile = model.model_copy(deep=True)
        self.seq: int = 0  # events applied so far
        self._ensure_head()

    # -- identity ---------------------------------------------------------

    def device_list(self) -> List[DeviceProfile]:
        """The live device ring, in placement order."""
        return list(self.devices.values())

    def fleet_digest(self) -> str:
        """Shape identity: device names in ring order (drift-invariant)."""
        h = hashlib.sha1("|".join(self.devices).encode())
        return h.hexdigest()[:16]

    def model_digest(self) -> str:
        """Model identity: architecture scalars, not drifting loads."""
        m = self.model
        key = (
            f"{m.L}:{m.V}:{m.e_embed}:{m.hk}:{m.ek}:{m.hv}:{m.ev}:{m.n_kv}:"
            f"{m.b_layer}:{m.b_in}:{m.b_out}:{m.Q}:{m.is_moe}:"
            f"{m.n_routed_experts}:{m.experts_per_token}"
        )
        return hashlib.sha1(key.encode()).hexdigest()[:16]

    def key(self) -> tuple:
        return (self.fleet_digest(), self.model_digest())

    # -- event application ------------------------------------------------

    def apply(self, event) -> bool:
        """Mutate the snapshot under one event; True iff it was structural.

        Raises ``ValueError`` on events naming unknown devices, removing
        the last device, or re-joining a live name — a trace that does any
        of these is malformed, and silently skipping would let a replay
        diverge from the trace it claims to reproduce.
        """
        if isinstance(event, DeviceJoin):
            dev = event.device.model_copy(deep=True)
            if not dev.name:
                raise ValueError("join event carries an unnamed device")
            if dev.name in self.devices:
                raise ValueError(f"device {dev.name!r} is already in the fleet")
            dev.is_head = False  # the ring already has a head
            self.devices[dev.name] = dev
        elif isinstance(event, DeviceLeave):
            if event.name not in self.devices:
                raise ValueError(f"leave of unknown device {event.name!r}")
            if len(self.devices) == 1:
                raise ValueError("cannot remove the last device in the fleet")
            self.devices.pop(event.name)
            self._ensure_head()
        elif isinstance(event, ModelSwap):
            self.model = event.model.model_copy(deep=True)
        elif isinstance(event, DeviceDegrade):
            dev = self.devices.get(event.name)
            if dev is None:
                raise ValueError(f"degrade of unknown device {event.name!r}")
            dev.t_comm = max(0.0, dev.t_comm * event.t_comm_scale)
            if dev.comm_bandwidth:
                dev.comm_bandwidth *= event.bandwidth_scale
            if event.mem_scale != 1.0:
                s = max(0.0, event.mem_scale)
                dev.d_avail_ram = int(dev.d_avail_ram * s)
                for pool in ("d_avail_cuda", "d_avail_metal", "d_avail_tpu"):
                    cap = getattr(dev, pool)
                    if cap is not None:
                        setattr(dev, pool, int(cap * s))
        elif isinstance(event, LoadTick):
            # Check-THEN-mutate: the scheduler's quarantine path promises a
            # rejected event left the fleet untouched, so every jitter name
            # must be validated before the first t_comm (or expert_loads)
            # write — raising halfway through would leave a partially
            # applied event behind a "fleet untouched" record.
            unknown = [n for n in event.t_comm_jitter if n not in self.devices]
            if unknown:
                raise ValueError(
                    f"load jitter on unknown device {unknown[0]!r}"
                )
            if event.expert_loads is not None:
                self.model.expert_loads = list(event.expert_loads)
            for name, factor in event.t_comm_jitter.items():
                self.devices[name].t_comm = max(
                    0.0, self.devices[name].t_comm * factor
                )
        else:
            raise TypeError(f"not a fleet event: {type(event).__name__}")
        self.seq += 1
        return is_structural(event)

    # -- solvability guard (the quarantine gate's second layer) -----------

    # Scalar fields the coefficient builders consume directly: one NaN here
    # poisons every bound of the sweep. The per-tick check scans ONLY these
    # scalars (not the throughput tables — those enter via join/model_swap
    # events, whose full payloads are walked once at event validation), so
    # it is O(M) cheap enough to run unconditionally.
    _SCALAR_FIELDS = (
        "t_comm", "comm_latency", "comm_bandwidth", "T_cpu", "s_disk",
        "t_kvcpy_cpu", "t_kvcpy_gpu", "t_ram2vram", "t_vram2ram",
    )

    def non_finite_reason(self) -> str | None:
        """First non-finite solver-consumed scalar, or None when clean.

        The scheduler refuses to solve (and serves its last-known-good
        placement) when this returns a reason: a poisoned fleet state must
        never reach ``build_coeffs``.
        """
        import math

        for name, dev in self.devices.items():
            for fld in self._SCALAR_FIELDS:
                v = getattr(dev, fld)
                if v is not None and not math.isfinite(v):
                    return f"device {name!r} field {fld} is non-finite ({v!r})"
        loads = self.model.expert_loads
        if loads is not None and any(not math.isfinite(v) for v in loads):
            return "model.expert_loads contains a non-finite entry"
        return None

    def _ensure_head(self) -> None:
        """Exactly one head device, and it is the first in ring order.

        The solver requires the head (I/O-layer owner) to exist; when the
        head leaves, the first surviving device is promoted.
        """
        devs = list(self.devices.values())
        for i, d in enumerate(devs):
            d.is_head = i == 0
