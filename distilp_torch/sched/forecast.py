"""Churn forecasting: predict the fleet's next drift states from its past.

The serving path's latency is dominated by solve time, yet the churn that
triggers those solves is highly predictable: drift traces are smooth
multiplicative walks (gradual decay compounds small ``t_comm_scale``
degrades), bursts relax back to where they came from, and flapping load
oscillates between a handful of states. ``ChurnForecaster`` turns that
predictability into concrete candidate *futures* — full device lists the
speculative pre-solver (``sched.speculate``) prices ahead of time.

Model, deliberately tiny and deterministic: one channel per device for the
``t_comm`` scalar (the coefficient every drift event class perturbs —
``DeviceDegrade.t_comm_scale`` and ``LoadTick.t_comm_jitter`` both
multiply it), tracked in LOG space because drift is multiplicative. Each
applied event updates, per channel:

- ``last``  — the live value (what the fleet holds right now);
- ``prev``  — the value before the most recent change (the state an
  oscillation or a spike-relax cycle returns to);
- ``trend`` — an EWMA of the per-event log-steps (Holt-style smoothed
  linear trend: a decay trace's compounding 1–5% degrades average to a
  persistent positive trend; an oscillation's alternating ±d averages to
  ~0, which is exactly right — "revert" covers it instead).

``forecast()`` emits up to K candidate fleets with confidence weights:
``revert`` (every channel returns to ``prev`` — bursts and flaps), then
``trend×h`` horizons (``last·exp(h·trend)`` — decay continuation). The
whole thing is a pure function of the APPLIED event stream: same events,
same forecasts, bit for bit — quarantined events never reach ``observe``
(the scheduler only calls it after ``FleetState.apply`` succeeded), so a
NaN-poisoned event cannot corrupt the EWMA state silently, and a
defensive finite-check skips any non-finite channel value anyway.

Only ``t_comm`` is *forecast*; every other drift channel (bandwidth,
memory, expert loads) is held at its live value in the candidates. That
is not an accident: ``halda_solve_scenarios`` shares one device-resident
static half across the batch, and t_comm futures are exactly the drift
class it documents as in-class. Out-of-class drift still lands in the
speculation bank's *digest* (``sched.speculate``), so an unforecast
channel moving produces an honest miss, never a mispriced hit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from ..common import DeviceProfile

# EWMA factor for the per-event log-step trend. 0.4 weighs the last few
# events heavily (churn regimes shift fast) while still averaging an
# oscillation's alternating steps toward zero within a cycle or two.
TREND_BETA = 0.4

# Guard for log(): t_comm can legitimately be driven to 0.0 by compounding
# degrades (fleet.apply clamps at max(0.0, ...)).
_EPS = 1e-12


class ChurnForecaster:
    """Per-device EWMA + linear-trend predictor over applied churn events.

    >>> fc = ChurnForecaster()
    >>> fc.observe(scheduler.fleet)          # after every APPLIED event
    >>> for devs, weight in fc.forecast(scheduler.fleet, k=3):
    ...     ...                              # candidate near-future fleets
    """

    def __init__(self, beta: float = TREND_BETA):
        if not 0.0 < beta <= 1.0:
            raise ValueError(f"trend beta must be in (0, 1] (got {beta})")
        self.beta = beta
        # name -> {"last": float, "prev": float, "trend": float}
        self._channels: Dict[str, Dict[str, float]] = {}

    def __len__(self) -> int:
        return len(self._channels)

    def observe(self, fleet) -> None:
        """Fold the fleet's post-event channel values into the predictor.

        Call ONLY after an event was applied (the quarantine gates run
        first) — the forecaster must never learn from rejected input.
        Devices that left the fleet drop their state; unchanged channels
        leave ``prev``/``trend`` alone so a no-op load tick does not decay
        the memory of the last real move.
        """
        live = set(fleet.devices)
        for dev in fleet.devices.values():
            v = dev.t_comm
            if not (isinstance(v, (int, float)) and math.isfinite(v)):
                # Defensive only: the scheduler's quarantine layers keep
                # non-finite values out of the fleet; skipping the update
                # (but keeping the channel's finite history) keeps the
                # forecaster advisory rather than raising.
                continue
            ch = self._channels.get(dev.name)
            if ch is None:
                self._channels[dev.name] = {
                    "last": float(v), "prev": float(v), "trend": 0.0,
                }
                continue
            old = ch["last"]
            if v == old:
                continue
            step = math.log(max(float(v), _EPS)) - math.log(max(old, _EPS))
            ch["prev"] = old
            ch["last"] = float(v)
            ch["trend"] = self.beta * step + (1.0 - self.beta) * ch["trend"]
        for name in list(self._channels):
            if name not in live:
                del self._channels[name]

    def forecast(
        self, fleet, k: int
    ) -> List[Tuple[List[DeviceProfile], float]]:
        """Up to ``k`` candidate near-future fleets with confidence weights.

        Candidate 0 is ``revert`` (every tracked channel back to ``prev``);
        candidates 1.. extrapolate the smoothed trend ``h`` steps. Each is
        a deep-copied device list safe to mutate/solve; weights decay
        geometrically and sum to 1 over the emitted list. Candidates whose
        channels all equal the live values are skipped (the live instance
        is banked by the real tick itself), so fewer than ``k`` may come
        back — or none, before any drift has been observed.
        """
        if k < 1 or not self._channels:
            return []
        plans: List[Tuple[Dict[str, float], float]] = []
        revert = {
            name: ch["prev"]
            for name, ch in self._channels.items()
            if ch["prev"] != ch["last"]
        }
        if revert:
            plans.append((revert, 1.0))
        h = 1
        while len(plans) < k:
            stepped = {
                name: ch["last"] * math.exp(h * ch["trend"])
                for name, ch in self._channels.items()
                if ch["trend"] != 0.0
            }
            if not stepped:
                break
            plans.append((stepped, 0.5**h))
            h += 1
        if not plans:
            return []
        total = sum(w for _, w in plans)
        out: List[Tuple[List[DeviceProfile], float]] = []
        for overrides, w in plans[:k]:
            devs = [d.model_copy(deep=True) for d in fleet.device_list()]
            for dev in devs:
                if dev.name in overrides:
                    dev.t_comm = max(0.0, float(overrides[dev.name]))
            out.append((devs, w / total))
        return out

    # -- snapshot/restore (rides Scheduler.dump_state) ---------------------

    def dump_state(self) -> dict:
        """JSON-able forecaster state; floats round-trip bit-exact."""
        return {
            "beta": self.beta,
            "channels": {
                name: dict(ch) for name, ch in self._channels.items()
            },
        }

    def load_state(self, state: Optional[dict]) -> None:
        """Restore a ``dump_state`` blob (None/empty restores clean)."""
        self._channels = {}
        if not state:
            return
        self.beta = float(state.get("beta", TREND_BETA))
        for name, ch in state.get("channels", {}).items():
            self._channels[name] = {
                "last": float(ch["last"]),
                "prev": float(ch["prev"]),
                "trend": float(ch["trend"]),
            }

    def channel(self, name: str) -> Optional[dict]:
        """Read-only view of one device's channel state (tests/debug)."""
        ch = self._channels.get(name)
        return dict(ch) if ch is not None else None
