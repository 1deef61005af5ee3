"""The branch-and-bound sweep with its frontier node-sharded over a mesh (K10):
the port of ``distilp_tpu/parallel/mesh.py``.

The parallel axis of the search is its frontier: every node's LP relaxation
is independent. :func:`solve_sweep_sharded` runs the port's sweep
(``solver/search.py``) with each round's beam rows split over the mesh in
order: each shard's rows go through the LP engine (K1, or K5 at fleet scale)
and the exact rounding (K2, or its MoE mode) on that shard's device, and the
results are gathered onto shard 0, where the incumbent reduction, the round
epilogue (K3, and its per-k entries) and the best-bound-first compaction run
as in the unsharded sweep. The capacity, the beam and the root round's batch
are padded to multiples of the mesh size, as the reference does, so every
shard solves the same number of rows. A MoE sweep is seeded once with the
Lagrangian decomposition bounds (K7) before the frontier is split.

A row's LP result does not depend on its batch neighbours (an element that
converged or is skipped is frozen), so the sharded sweep reaches the
unsharded sweep's placement at the same padded capacity and beam.

The sweep solves through the loop's plan like every other sweep
(``solver/device_loop.py``): when every shard lies on the search's card, one
upload, one CUDA graph whose rounds launch the LP engine and K2 once a
shard at its row offset, and one read; a mesh over distinct cards keeps the
host loop (``search.run_bnb_loop`` with the node mesh).
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

from .devices import Mesh

NODE_AXIS = "nodes"


def pad_cap_to_mesh(cap: int, mesh: Mesh) -> int:
    """Round a frontier capacity (or beam) up to a multiple of the mesh size."""
    n = mesh.size
    return int(-(-int(cap) // n) * n)


def solve_sweep_sharded(
    arrays,
    kWs: Sequence,
    coeffs,
    mesh: Mesh,
    mip_gap: float = 1e-3,
    ipm_iters: Optional[int] = None,
    max_rounds: int = 48,
    beam: Optional[int] = None,
    node_cap: Optional[int] = None,
    per_k: bool = False,
    ipm_warm_iters: Optional[int] = None,
    lp_backend: Optional[str] = None,
    pdhg_iters: Optional[int] = None,
    pdhg_restart_tol: Optional[float] = None,
    timings: Optional[dict] = None,
):
    """Run the sweep with the frontier node-sharded across ``mesh`` (its
    shard 0's device holds the search). Search parameters default as in the
    unsharded sweep, then the capacity (at least 2 n_k), the beam and the
    root round's batch are rounded up to multiples of the mesh size.
    ``per_k`` prunes every node against its own k's incumbent (read the per-k
    assignments off the state's ``per_k_w/n/y``). ``timings`` receives
    ``upload_ms``, ``solve_ms`` (the search) and ``bnb_rounds``.

    Returns ``(state, sf)``: the final
    :class:`~distilp_torch.solver.search.SearchState` (one lane: every field
    carries a leading axis of 1) and the sweep's standard form."""
    from ..solver.backend_torch import _prepare, _search_params, lane_input, seeded_state
    from ..solver.search import SearchState, run_bnb_loop

    M = arrays.layout.M
    feasible = [(k, W) for (k, W) in kWs if W >= M]
    if not feasible:
        raise RuntimeError("No feasible MILP found for any k.")
    lane = lane_input(arrays, coeffs, kWs, feasible, per_k=per_k)
    n_k = len(lane.sf.ks)
    params = _search_params(lane.sf, node_cap, beam, ipm_iters, max_rounds, ipm_warm_iters,
                            lp_backend, pdhg_iters, None, None, per_k, pdhg_restart_tol)
    cap = pad_cap_to_mesh(max(params["cap"], 2 * n_k), mesh)
    params.update(cap=cap, beam=min(pad_cap_to_mesh(params["beam"], mesh), cap))
    root_beam = min(pad_cap_to_mesh(n_k, mesh), cap)
    prep = _prepare([lane], params, mip_gap, mesh.devices[0], per_k=per_k, shared_A=True,
                    node_mesh=mesh, root_beam=root_beam)
    t0 = time.perf_counter()
    try:
        if prep.plan is not None:
            # The answer (read once) reports the rounds; the final state
            # stays in the plan's second buffer.
            rounds = int(prep.plan.run(prep.entry, prep.warm, prep.root_warm)[0, 4])
            state = SearchState(*[t.clone() for t in prep.plan.states[1]])
        else:
            state, _, _ = run_bnb_loop(prep.data, seeded_state(prep)[0], mip_gap,
                                       **prep.loop_kw)
            rounds = None
    finally:
        prep.release()
    if timings is not None:
        if rounds is None:
            rounds = int(state.stat_rounds[0])
        timings.update(upload_ms=prep.stats["upload_ms"],
                       solve_ms=(time.perf_counter() - t0) * 1e3, bnb_rounds=rounds)
    return state, lane.sf
