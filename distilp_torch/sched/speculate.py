"""Speculative replanning: pre-solved placements served at cache-hit cost.

The warm-start line (iterate-carrying warm ticks, the warm graph plan)
makes the solve on the critical path cheaper; this
module moves it OFF the critical path entirely when churn is predictable.
After each real tick, the scheduler asks the forecaster
(``sched.forecast``) for K likely near-future fleets and prices them in
ONE ``halda_solve_scenarios`` call (the K futures are the lanes of
one branch-and-bound search on the card), warm-seeded from the
incumbent. The certified results land in a ``SpeculationBank`` keyed by a tolerance-bucketed
*instance digest*; when the next event's post-apply fleet digests to a
banked entry, the scheduler serves the pre-solved placement immediately
(published ``mode='spec'``) and the solve ladder never runs.

Digest semantics — the honesty contract:

- The digest covers EVERY drift channel (per-device ``t_comm``,
  ``comm_bandwidth``, memory pools, the model's ``expert_loads``) plus the
  fleet/model identity key, bucketed at ``tolerance`` relative width
  (log-space for the multiplicative channels). A hit therefore certifies
  "the live instance is within one tolerance bucket of the instance this
  placement was solved (and certified) for" — staleness bounded by
  construction, exactly the warm-hint soundness argument with an explicit
  tolerance instead of re-pricing.
- Channels the forecaster does NOT model (bandwidth, memory, loads) still
  move the digest, so unforecast drift produces an honest miss and falls
  through to the unchanged tick path.
- A structural event changes the identity key; ``invalidate()`` drops the
  stale entries (counted ``spec_stale``) rather than letting them match a
  different problem.

Bank entries carry the full ``HALDAResult`` including its Lagrangian duals
and LP iterates (``ipm_state``), so a hit can donate its scenario solve as
the next tick's warm seed; a miss donates nothing — speculative work must
never touch the replanner's warm state unless it was actually served.
"""

from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from typing import List, NamedTuple, Optional, Tuple

from ..solver.result import HALDAResult
from ..solver.streaming import _decode_state, _encode_state

DEFAULT_SPEC_K = 3
DEFAULT_SPEC_TOLERANCE = 0.05

_EPS = 1e-12


def _bucket_log(value: Optional[float], width: float) -> int:
    """Tolerance bucket of a positive multiplicative-drift scalar.

    ``None``/non-positive collapse to sentinels (absent capacity vs a
    zeroed coefficient are different instances); non-finite values get
    their own bucket so a poisoned profile can never alias a clean one.
    """
    if value is None:
        return -(10**9)
    if not math.isfinite(value):
        return 10**9
    if value <= 0:
        return -(10**9) + 1
    return round(math.log(max(float(value), _EPS)) / width)


def bucket_vector(devices, model, tolerance: float) -> Tuple[int, ...]:
    """The instance's drift coordinates as a flat tuple of tolerance
    buckets (the same channels, widths and order ``candidate_digest``
    hashes, minus the device names).

    Unlike the digest — which only answers "same bucket on every channel,
    yes or no" — the vector supports a DISTANCE: two instances of the same
    identity differ by ``max |bucket_i - bucket_j|`` tolerance steps on
    their worst channel. The degraded-mode near-match probe
    (``SpeculationBank.nearest``) ranks banked entries by exactly that.
    """
    w = math.log1p(tolerance)
    out: List[int] = []
    for dev in devices:
        out.extend(
            (
                _bucket_log(dev.t_comm, w),
                _bucket_log(dev.comm_bandwidth, w),
                _bucket_log(float(dev.d_avail_ram), w),
                _bucket_log(_accel_pool(dev), w),
            )
        )
    loads = model.expert_loads
    if loads is not None:
        out.extend(round(v / tolerance) for v in loads)
    return tuple(out)


def candidate_digest(devices, model, key, tolerance: float) -> str:
    """Tolerance-bucketed digest of one instance's DRIFT coordinates.

    Two instances with equal digests differ by at most ~``tolerance``
    (relative) on every drift channel and share fleet/model identity —
    close enough that a placement certified on one is served for the
    other under the bank's documented tolerance semantics. Used both for
    the live fleet (``instance_digest``) and for forecast candidates
    (device lists sharing the live fleet's identity key).
    """
    w = math.log1p(tolerance)
    parts: List[str] = ["|".join(key)]
    for dev in devices:
        parts.append(
            f"{dev.name}:{_bucket_log(dev.t_comm, w)}:"
            f"{_bucket_log(dev.comm_bandwidth, w)}:"
            f"{_bucket_log(float(dev.d_avail_ram), w)}:"
            f"{_bucket_log(_accel_pool(dev), w)}"
        )
    loads = model.expert_loads
    if loads is not None:
        # Linear bucketing: loads are mean-1 shares, so an absolute
        # ``tolerance`` step is the natural unit.
        parts.append(
            ",".join(str(round(v / tolerance)) for v in loads)
        )
    return hashlib.sha1("\n".join(parts).encode()).hexdigest()[:20]


def instance_digest(fleet, tolerance: float) -> str:
    """``candidate_digest`` of a live ``FleetState``."""
    return candidate_digest(
        fleet.device_list(), fleet.model, fleet.key(), tolerance
    )


def _accel_pool(dev) -> Optional[float]:
    for pool in ("d_avail_cuda", "d_avail_metal", "d_avail_tpu"):
        cap = getattr(dev, pool, None)
        if cap is not None:
            return float(cap)
    return None


class BankEntry(NamedTuple):
    """One pre-solved placement, ready to serve on a digest match."""

    result: HALDAResult
    key: Tuple[str, str]  # fleet/model identity the solve priced
    weight: float  # forecast confidence (1.0 for banked real ticks)
    solved_seq: int  # fleet seq the presolve was dispatched at
    # Bucket coordinates of the instance the entry was certified on
    # (``bucket_vector``); None on entries banked before the near-match
    # probe existed — they still serve exact hits, just never near ones.
    buckets: Optional[Tuple[int, ...]] = None


class SpeculationBank:
    """Bounded LRU of certified speculative placements, digest-keyed.

    Shard-owned by construction: each scheduler builds its own bank and
    every access happens on that shard's (single) tick path, so — like
    the warm pool — no locking is needed or taken.
    """

    def __init__(
        self,
        capacity: int = 4 * DEFAULT_SPEC_K,
        tolerance: float = DEFAULT_SPEC_TOLERANCE,
    ):
        if capacity < 1:
            raise ValueError("speculation bank capacity must be >= 1")
        if not 0.0 < tolerance < 1.0:
            raise ValueError(
                f"spec tolerance must be in (0, 1) (got {tolerance})"
            )
        self.capacity = capacity
        self.tolerance = tolerance
        self._entries: "OrderedDict[str, BankEntry]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, digest: str) -> bool:
        return digest in self._entries

    def digest(self, fleet) -> str:
        return instance_digest(fleet, self.tolerance)

    def put(self, digest: str, entry: BankEntry) -> None:
        """Insert/refresh an entry (LRU position renewed; LRU evicted)."""
        self._entries[digest] = entry
        self._entries.move_to_end(digest)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def probe(self, digest: str, key: Tuple[str, str]) -> Optional[BankEntry]:
        """The banked entry for this digest under this identity, or None.

        The identity check is belt-and-braces (the digest already folds
        the key in); a hit renews recency so live futures outlast dead
        ones under the LRU bound.
        """
        entry = self._entries.get(digest)
        if entry is None or entry.key != key:
            return None
        self._entries.move_to_end(digest)
        return entry

    def nearest(
        self, devices, model, key: Tuple[str, str], max_radius: int
    ) -> Optional[Tuple[BankEntry, int]]:
        """The closest certified banked entry within ``max_radius``
        tolerance buckets of the live instance, or None.

        Degraded-mode serving's probe (``mode='spec_near'``): when a shard
        is behind, a placement certified on an instance a few tolerance
        steps away beats queueing the solve past the deadline. Distance is
        the worst channel's bucket gap (L-inf over ``bucket_vector``), so
        ``max_radius`` bounds staleness per channel: every coefficient of
        the served instance is within ~``(1 + tolerance)^max_radius`` of
        the instance the placement was certified on. Identity must match
        exactly (a near-match across fleets/models is a different problem,
        not a stale one); entries without bucket coordinates never match.
        A hit renews LRU recency, like ``probe``.
        """
        live = bucket_vector(devices, model, self.tolerance)
        best: Optional[Tuple[str, BankEntry, int]] = None
        for digest, e in self._entries.items():
            if (
                e.key != key
                or e.buckets is None
                or len(e.buckets) != len(live)
                or not e.result.certified
            ):
                continue
            dist = (
                max(abs(a - b) for a, b in zip(live, e.buckets))
                if live
                else 0
            )
            if dist > max_radius:
                continue
            if best is None or dist < best[2]:
                best = (digest, e, dist)
        if best is None:
            return None
        self._entries.move_to_end(best[0])
        return best[1], best[2]

    def invalidate(self, key: Tuple[str, str]) -> int:
        """Drop entries NOT priced under ``key``; returns how many (the
        ``spec_stale`` count after a structural identity change)."""
        stale = [d for d, e in self._entries.items() if e.key != key]
        for d in stale:
            del self._entries[d]
        return len(stale)

    def clear(self) -> int:
        n = len(self._entries)
        self._entries.clear()
        return n

    # -- snapshot/restore (rides Scheduler.dump_state) ---------------------

    def dump_state(self) -> dict:
        """JSON-able bank contents; LP iterates travel bit-exact (the same
        base64-raw-bytes encoding the warm-state blob uses), so a restored
        hit donates byte-identical warm seeds."""
        return {
            "capacity": self.capacity,
            "tolerance": self.tolerance,
            "entries": [
                {
                    "digest": digest,
                    "key": list(e.key),
                    "weight": e.weight,
                    "solved_seq": e.solved_seq,
                    "buckets": (
                        list(e.buckets) if e.buckets is not None else None
                    ),
                    "result": e.result.model_dump(),
                    "ipm_state": _encode_state(e.result.ipm_state),
                }
                for digest, e in self._entries.items()
            ],
        }

    def load_state(self, state: Optional[dict]) -> None:
        """Restore a ``dump_state`` blob (None/empty restores clean);
        configured capacity/tolerance stay the constructor's — the blob
        carries state, not config — so entries beyond a smaller restored
        capacity evict LRU-style."""
        self._entries.clear()
        if not state:
            return
        for rec in state.get("entries", []):
            result = HALDAResult.model_validate(rec["result"])
            result.ipm_state = _decode_state(rec.get("ipm_state"))
            buckets = rec.get("buckets")
            self.put(
                rec["digest"],
                BankEntry(
                    result=result,
                    key=tuple(rec["key"]),
                    weight=float(rec.get("weight", 1.0)),
                    solved_seq=int(rec.get("solved_seq", 0)),
                    buckets=(
                        tuple(int(b) for b in buckets)
                        if buckets is not None
                        else None
                    ),
                ),
            )

    def snapshot(self) -> List[dict]:
        """Compact live view (flight recorder / debug), oldest first."""
        return [
            {
                "digest": d,
                "k": e.result.k,
                "certified": e.result.certified,
                "weight": round(e.weight, 4),
                "solved_seq": e.solved_seq,
            }
            for d, e in self._entries.items()
        ]


def presolve_candidates(
    candidates,
    model,
    *,
    k_candidates=None,
    mip_gap: float,
    kv_bits: str,
    moe,
    warm: Optional[HALDAResult],
    load_factors=None,
    lp_backend: str = "auto",
    pdhg_iters: Optional[int] = None,
    pdhg_restart_tol: Optional[float] = None,
    pdhg_dtype: Optional[str] = None,
    device=None,
) -> List[HALDAResult]:
    """Solve the forecast candidates as ONE scenario batch on ``device``.

    ``candidates`` is the forecaster's ``[(devices, weight), ...]``; the
    incumbent ``warm`` seeds every scenario (what-ifs ARE drifts of the
    current placement). Raises exactly what ``halda_solve_scenarios``
    raises; the scheduler treats any failure as "no speculation this
    tick", never as a serving fault.
    """
    from ..solver import halda_solve_scenarios

    fleets = [devs for devs, _w in candidates]
    return halda_solve_scenarios(
        fleets,
        model,
        k_candidates=k_candidates,
        mip_gap=mip_gap,
        kv_bits=kv_bits,
        moe=moe,
        warms=[warm] * len(fleets) if warm is not None else None,
        load_factors_list=(
            [load_factors] * len(fleets) if load_factors is not None else None
        ),
        lp_backend=lp_backend,
        pdhg_iters=pdhg_iters,
        pdhg_restart_tol=pdhg_restart_tol,
        pdhg_dtype=pdhg_dtype,
        device=device,
    )
