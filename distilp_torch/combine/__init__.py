"""Cross-shard solve combiner: many shards' ticks, one batched search.

The port's copy of ``distilp_tpu/combine``. A hundred fleets each paying a
warm solve serially waste what the card is best at: many lanes of one
search. This package sits in the gateway ingest path *behind* the
coalescer: each shard's pending drift run is packed
(``Scheduler.prepare_combine`` → ``solver.batchlayout.pack_instance``)
instead of solved, grouped into a shape bucket by its packed signature, and
one ``solve_batch`` per bucket prices every member at once (on the card,
one launch of the branch-and-bound graph whose rounds run the round tail in
its lanes mode and K1 on each lane's own A). Results scatter back onto each
shard's worker (``Scheduler.adopt_combine``), so warm state, the speculation
bank, flight records and the published ``PlacementView`` are what the
per-shard path would have produced (mode/metrics aside).

Two committed pieces:

- ``BucketPolicy`` — the shape-bucket contract: a fixed ladder of padded
  fleet sizes (mixed real M inside a bucket rides phantom padding — see
  ``solver.batchlayout``), a lane cap sized against the ``ops.memmodel``
  analytic padding budget, and the flush triggers (full bucket / max
  wait). *Committed* means the boundaries never adapt to traffic: every
  reachable batch shape is a finite, enumerable set, which is what lets
  ``Gateway.warm_combine`` capture every graph the serving phase needs.

- ``SolveCombiner`` — the flush thread: buckets pending tickets by
  signature, dispatches ``solve_batch`` per bucket on the combiner's
  device, and delivers each lane back to its shard.
"""

from .policy import BucketPolicy
from .combiner import CombineEntry, SolveCombiner

__all__ = ["BucketPolicy", "SolveCombiner", "CombineEntry"]
