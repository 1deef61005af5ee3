"""The committed bucket policy: which padded shapes exist, how full a
batch may get, and how long a lane may wait.

The port's copy of ``distilp_tpu/combine/policy.py``. The policy is
COMMITTED — fixed at configuration time, never adapted to observed
traffic — because the batch shape ladder is also the set of graphs the
card runs: a dense sweep's search is one captured CUDA graph per plan
signature (``solver.device_loop``), and the signature holds the padded M
and the lane count. Every ``(M_pad, batch <= lane cap)`` pair this policy
can emit is a graph some flush may need, and the gateway's no-capture-
after-warmup contract only holds if that set is finite and captured once.
(An adaptive bucketer that split or merged boundaries under load would
mint fresh shapes mid-flood — a capture per new shape.)

``quantize_lanes`` therefore snaps every dispatch to a power-of-two lane
count (clamped to the cap) and ``solve_batch`` fills the extra lanes by
repeating the last instance — at most 2x phantom solve work buys a
reachable set of exactly ``len(boundaries) x (log2(max_batch)+1)`` lane
shapes, all of which ``Gateway.warm_combine`` solves (and so captures)
before the serving phase begins.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

# Default padded-M ladder: powers of two through the fleet sizes the
# serving tier actually sees. Fleets above the top boundary bucket at
# exact M (no padding) — they are rare enough that shape sharing stops
# paying for the phantom work.
DEFAULT_BOUNDARIES: Tuple[int, ...] = (2, 4, 8, 16, 32, 64, 128)

# Default max lanes per dispatch. The real bound is usually the memory
# budget (``lane_cap``); 16 keeps the decode loop short even when memory
# is plentiful.
DEFAULT_MAX_BATCH = 16

# Default flush deadline: how long the FIRST lane of a bucket may wait
# for company before the bucket dispatches anyway. Two milliseconds is
# well under a warm solve, so a lone shard's latency floor barely moves
# while a flood fills buckets long before the deadline.
DEFAULT_MAX_WAIT_MS = 2.0


@dataclass(frozen=True)
class BucketPolicy:
    """Shape-bucket contract for the cross-shard combiner.

    ``boundaries`` — ascending padded fleet sizes; ``pad_for(M)`` snaps a
    fleet to the smallest boundary that fits (or exact M above the top).
    ``max_batch`` — hard lane cap per dispatch. ``max_wait_ms`` — flush
    deadline for an under-full bucket. ``mem_budget_bytes`` — optional
    analytic padding budget: when set, ``lane_cap`` shrinks the lane
    count so the bucket's peak working set (``ops.memmodel.peak_bytes``
    at the PADDED M, times lanes) stays inside it — the memory ledger's
    headroom signal stays honest under combined dispatches.
    """

    boundaries: Tuple[int, ...] = DEFAULT_BOUNDARIES
    max_batch: int = DEFAULT_MAX_BATCH
    max_wait_ms: float = DEFAULT_MAX_WAIT_MS
    mem_budget_bytes: Optional[int] = None
    engine: str = "ipm"  # memmodel engine the budget is priced against

    def __post_init__(self) -> None:
        bounds = tuple(int(b) for b in self.boundaries)
        if not bounds or any(b < 1 for b in bounds):
            raise ValueError(f"boundaries must be positive: {bounds}")
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(
                f"boundaries must be strictly ascending: {bounds}"
            )
        object.__setattr__(self, "boundaries", bounds)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {self.max_batch})")
        if self.max_wait_ms < 0:
            raise ValueError(
                f"max_wait_ms must be >= 0 (got {self.max_wait_ms})"
            )

    def pad_for(self, M: int) -> int:
        """The committed padded size for a fleet of ``M`` real devices:
        the smallest boundary >= M, or exact M above the top boundary."""
        if M < 1:
            raise ValueError(f"fleet size must be >= 1 (got {M})")
        for b in self.boundaries:
            if b >= M:
                return b
        return M

    def lane_cap(self, M_pad: int) -> int:
        """Max lanes a bucket at ``M_pad`` may batch: ``max_batch``,
        shrunk to the memory budget when one is set (at least one lane —
        a single-lane dispatch is the per-shard working set, which the
        per-shard path would have paid anyway)."""
        cap = self.max_batch
        if self.mem_budget_bytes is not None:
            from ..ops.memmodel import peak_bytes

            per_lane = peak_bytes(M_pad, self.engine)
            cap = min(cap, max(1, int(self.mem_budget_bytes // per_lane)))
        return cap

    def quantize_lanes(self, n: int, M_pad: int) -> int:
        """The committed lane count for an ``n``-instance flush: the
        smallest power of two >= n, clamped to ``lane_cap(M_pad)``. This
        is the lane-axis half of the no-capture-after-warmup contract — the set of
        lane counts a bucket can dispatch at is {1, 2, 4, ..., cap}, all
        of which warmup can enumerate."""
        if n < 1:
            raise ValueError(f"lane count must be >= 1 (got {n})")
        cap = self.lane_cap(M_pad)
        q = 1
        while q < n:
            q *= 2
        return min(q, max(cap, n))

    def lane_shapes(self, M_pad: int) -> Tuple[int, ...]:
        """Every lane count ``quantize_lanes`` can emit for this bucket:
        the powers of two up to the cap, plus the cap itself when it is
        not a power of two. Warmup iterates exactly this set."""
        cap = self.lane_cap(M_pad)
        shapes = []
        q = 1
        while q < cap:
            shapes.append(q)
            q *= 2
        shapes.append(cap)
        return tuple(shapes)
