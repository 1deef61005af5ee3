"""GPU backend: the whole HALDA k-sweep as batched branch-and-bound.

Every k-candidate's LP relaxation and every branch-and-bound node of a round
is one element of a single batched LP launch (the interior-point kernel, or
at fleet scale the PDHG kernel); integer incumbents
come from the exact rounding kernel; pruning uses the float64 Lagrangian
bounds, so the mip-gap certificate does not depend on LP convergence; one
global incumbent prunes across all k trees. Ported from
``distilp_tpu/solver/backend_jax.py::solve_sweep_jax``: the same standard
form, the same float32 materialization of the device arrays (slack and cycle
boxes recomputed in float32 from ``smin_k``/``C_ub_k``; in MoE mode the
objective's y block from the per-k expert-busy table), the same warm
incumbent re-pricing and root-iterate carry, and the same ``(results, best)``
contract. MoE sweeps add the Lagrangian decomposition root
bounds (K7), from scratch or, on a warm tick, at the previous solve's
multipliers (``duals``), which the result carries on. ``per_k_optima``
(K3's per-k mode) certifies every k on its own, with the per-k decode of
``_decode_sweep_out``; ``collect=False`` (``PendingSweep``/``collect_sweep``)
runs the search on a worker thread while the caller goes on.

Several sweeps search as lanes of one batch (the reference's
``_solve_scenarios_packed``/``_solve_batched``, B12): each sweep's host
half is a :class:`LaneInput`; :func:`solve_sweep_scenarios` runs S
scenarios of one fleet on one shared A, and ``batchlayout.solve_batch``
runs lanes with an A each. A single sweep is one lane. MoE streaming ticks
may take their root bounds from the margin fast path
(:func:`margin_bounds_from_state`).
"""

from __future__ import annotations

import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..ops.decomp import decomp_problem, stack_problems
from ..ops.pdhg import DEFAULT_RESTART_TOL, resolve_pdhg_dtype
from ..parallel.devices import shard_mesh
from .assemble import MilpArrays, VarLayout
from .coeffs import HaldaCoeffs
from .result import ILPResult
from . import packed
from .device_loop import (
    acquire_plan,
    answer_rows,
    forced_host_loop,
    loop_route,
    note_route,
    pdhg_plan,
    plan_sig,
    release_plan,
    row_mesh_plan,
)
from .search import (
    BDTYPE,
    RL_COLS,
    SearchState,
    SweepData,
    node_mesh_of,
    root_state,
    run_bnb_loop,
    seed_root_bounds,
    seed_warm,
)
from .standard_form import (
    DECOMP_STEPS_COLD,
    DECOMP_STEPS_WARM,
    MOE_LOCAL_MOVES_WARM,
    RD_VEC_FIELDS,
    StandardForm,
    build_standard_form,
    gky_scatter_table,
    resolve_search_params,
    rounding_arrays_np,
)
from ..obs import compile_ledger as _compile_ledger
from ..obs.compile_ledger import instrument as _instrument


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device; raises without a GPU (the solve
    never drops to the CPU on its own)."""
    return kernels.resolve_device(
        device, "halda_solve(backend='torch')", ", or backend='cpu' for the HiGHS oracle"
    )


def warm_inputs(
    sf: StandardForm,
    warm: Optional[ILPResult],
    feasible: Sequence[Tuple[int, int]],
    E: int = 0,
):
    """(warm_tuple, duals_tuple, root_warm_tuple) of a previous solve: its
    integer assignment ``(k_index, w, n, y)`` to re-price as the first
    incumbent (a MoE hint without a usable expert split gets E spread
    evenly), its Lagrangian multipliers ``(lam, mu, tau)`` (MoE, when their
    shapes match and they are finite), and its root-round IPM iterates
    ``(ok, v, y, z, f)`` when their shapes match this sweep (finite-ness is
    not gated: the kernel starts non-finite elements cold)."""
    M = sf.M
    n_k = len(sf.ks)
    warm_tuple = None
    if warm is not None and warm.w is not None and len(warm.w) == M:
        k_index = {k: j for j, (k, _) in enumerate(feasible)}
        if warm.k in k_index:
            if not sf.moe:
                warm_y = [0] * M
            elif warm.y is not None and sum(warm.y) == E:
                warm_y = warm.y
            else:
                warm_y = [E // M + (1 if i < E % M else 0) for i in range(M)]
            warm_tuple = (k_index[warm.k], warm.w, warm.n, warm_y)

    duals_tuple = None
    if warm is not None and warm.duals is not None and sf.moe:
        try:
            lam, mu, tau = (np.asarray(warm.duals[f], np.float64)
                            for f in ("lam", "mu", "tau"))
        except (KeyError, TypeError, ValueError):
            lam = None
        if (
            lam is not None
            and lam.shape == (n_k,) and mu.shape == (n_k,) and tau.shape == (n_k, M)
            and all(np.isfinite(a).all() for a in (lam, mu, tau))
        ):
            duals_tuple = (lam, mu, tau)

    root_warm_tuple = None
    ipm_state = getattr(warm, "ipm_state", None) if warm is not None else None
    if ipm_state is not None:
        m, nf = sf.A.shape[1], sf.A.shape[2]
        try:
            arrs = [np.asarray(ipm_state[f], np.float32) for f in ("v", "y", "z", "f")]
            ok = np.asarray(ipm_state["ok"], np.float32)
        except (KeyError, TypeError, ValueError):
            ok = None
        if ok is not None and ok.shape == (n_k,) and [a.shape for a in arrs] == [
            (n_k, nf), (n_k, m), (n_k, nf), (n_k, nf)
        ]:
            root_warm_tuple = (ok, *arrs)
    return warm_tuple, duals_tuple, root_warm_tuple


def device_arrays(sf: StandardForm, g_raw=None) -> dict:
    """The float32 LP family as the device solves it (numpy, host side).

    Mirrors the reference's packed static/dynamic materialization: A, c, the
    boxes and the slack minima are cast to float32 first, then the slack
    boxes ``max(b - (smin + cmin), 0)`` and the cycle box are recomputed in
    float32 from ``C_ub_k`` (casting ``hi_k`` down would give other boxes).
    In MoE mode (``g_raw`` given) A is the g-free base, the objective's y
    block is the float32 g_raw / k, and ``gky`` holds the per-k expert-busy
    entries each node's A gets (``search.node_A``).
    """
    lay = VarLayout(sf.M, sf.moe)
    N, C_idx = lay.n_vars, lay.C
    m, nf = sf.A.shape[1], sf.A.shape[2]
    m_ub = m - lay.n_eq
    f32 = np.float32
    A = np.asarray(sf.A_base, f32)
    lo = np.asarray(sf.lo_k, f32)
    hi = np.asarray(sf.hi_k, np.float64).copy()
    hi[:, N:] = 0.0
    hi[:, C_idx] = 0.0
    hi = hi.astype(f32)
    smin = np.asarray(sf.smin_k, f32)
    b = np.asarray(sf.b_k, f32)
    C_ub = np.asarray(sf.C_ub_k, np.float64).astype(f32)
    aC = A[:m_ub, C_idx]
    cmin = np.minimum(aC[None, :] * lo[:, C_idx][:, None], aC[None, :] * C_ub[:, None])
    hi[:, N:] = np.maximum(b[:, :m_ub] - (smin + cmin), f32(0.0))
    hi[:, C_idx] = C_ub
    c = np.asarray(sf.c_k, f32).copy()
    out = dict(A=A, b_k=b, c_k=c, lo_k=lo, hi_k=hi, int_mask=np.asarray(sf.int_mask, bool))
    if sf.moe:
        M = sf.M
        gky, table = gky_scatter_table(g_raw, sf.ks, sf.gscale)
        c[:, 2 * M : 3 * M] = gky
        out["gky"] = table
    return out


def pack_static(sf: StandardForm) -> np.ndarray:
    """The drift-invariant half of a sweep as one float32 vector, as the
    reference packs it (``_pack_static``): the base A, the structural
    objective (MoE: y columns zeroed), the root boxes (slack columns and the
    C entry of ``hi`` zeroed: they move with the right-hand side), the slack
    minima and the integer mask. Scenarios share one A exactly when these
    bytes are equal; a batch lane's device copy is cached by them."""
    lay = VarLayout(sf.M, sf.moe)
    c_struct = np.asarray(sf.c_k, np.float64).copy()
    hi_struct = np.asarray(sf.hi_k, np.float64).copy()
    hi_struct[:, lay.n_vars:] = 0.0
    hi_struct[:, lay.C] = 0.0
    if sf.moe:
        c_struct[:, 2 * sf.M : 3 * sf.M] = 0.0
    return np.concatenate(
        [
            np.asarray(sf.A_base, np.float32).ravel(),
            c_struct.astype(np.float32).ravel(),
            np.asarray(sf.lo_k, np.float32).ravel(),
            hi_struct.astype(np.float32).ravel(),
            np.asarray(sf.smin_k, np.float32).ravel(),
            sf.int_mask.astype(np.float32),
        ],
        dtype=np.float32,
    )


# rd fields the margin path absorbs as drift, and those that must equal the
# anchor's exactly (they shape the ceil staircases, the ok mask, or enter
# cells with cell-internal coefficients).
MARGIN_DRIFT_FIELDS = ("a", "busy_const", "g_raw")
MARGIN_EXACT_FIELDS = tuple(f for f in RD_VEC_FIELDS if f not in MARGIN_DRIFT_FIELDS)


def margin_bounds_from_state(
    margin_state: dict, rd: dict, sf: StandardForm,
    duals: Tuple[np.ndarray, np.ndarray, np.ndarray],
) -> Optional[np.ndarray]:
    """Per-k Lagrangian bounds for THIS tick, re-derived on the host from
    the last full evaluation's y-profile ``m_y`` (K7's float64 minima per
    (k, device, y)), or None when reuse is unsound (the reference's
    ``margin_bounds_from_state``, host numpy).

    At fixed multipliers the per-device term decomposes exactly over drift
    confined to the linear channels: g_raw shifts the y-profile by
    (1 + theta) (dg/k) y (exact, re-minimised over y), ``a`` adds
    (1 + theta) da w (a separate min over w in [1, W]: a valid lower bound,
    exact when da = 0), busy_const adds theta dbusy. Every correction is
    taken against the fixed anchor, so margin ticks do not decay the chain.
    Reuse needs the same k grid and fleet size, byte-identical exact-match
    fields, b' and E, and the multipliers the anchor was evaluated at; the
    bound is slackened by 1e-9 (1 + |bound|) against host-versus-device
    rounding of theta."""
    prev_rd = margin_state.get("rd")
    m_y = margin_state.get("m_y")
    if prev_rd is None or m_y is None:
        return None
    ks = np.asarray(sf.ks, np.float64)
    Ws = np.asarray(sf.Ws, np.float64)
    if not (np.array_equal(margin_state.get("ks"), ks)
            and np.array_equal(margin_state.get("Ws"), Ws)):
        return None
    M = rd["a"].shape[0]
    E = float(rd["E"])
    if m_y.shape != (ks.shape[0], M, int(E) + 1):
        return None
    for f in MARGIN_EXACT_FIELDS:
        if not np.array_equal(prev_rd[f], rd[f]):
            return None
    if not (np.array_equal(prev_rd["bprime"], rd["bprime"])
            and np.array_equal(prev_rd["E"], rd["E"])):
        return None
    prev_duals = margin_state.get("duals")
    if prev_duals is None or not all(
        np.array_equal(np.asarray(p, np.float64), np.asarray(q, np.float64))
        for p, q in zip(prev_duals, duals)
    ):
        return None

    lam, mu, tau = (np.asarray(p, np.float64) for p in duals)
    t = np.exp(tau - tau.max(axis=1, keepdims=True))
    theta = (ks - 1.0)[:, None] * (t / t.sum(axis=1, keepdims=True))
    dG = np.asarray(rd["g_raw"] - prev_rd["g_raw"], np.float64)
    dA = np.asarray(rd["a"] - prev_rd["a"], np.float64)
    dB = np.asarray(rd["busy_const"] - prev_rd["busy_const"], np.float64)
    y_vals = np.arange(0, int(E) + 1, dtype=np.float64)
    kappa = (1.0 + theta) * dG[None, :] / ks[:, None]
    per_dev = (m_y + kappa[:, :, None] * y_vals[None, None, :]).min(axis=2)
    a_coef = (1.0 + theta) * dA[None, :]
    per_dev = per_dev + np.minimum(a_coef, a_coef * Ws[:, None])
    per_dev = per_dev + theta * dB[None, :]
    bound = per_dev.sum(axis=1) + lam * Ws + mu * E
    bound = bound - 1e-9 * (1.0 + np.abs(bound))
    infeasible = np.isposinf(per_dev).any(axis=1)
    bound = np.where(infeasible, np.inf, bound)
    if np.isnan(bound).any():
        return None
    return bound


class LaneInput(NamedTuple):
    """The host half of one sweep (one lane), built and not yet uploaded."""

    sf: StandardForm
    host: dict  # device_arrays(sf, g_raw): the float32 LP family
    rd_np: dict  # float64 rounding data
    feasible: List[Tuple[int, int]]
    kWs: List[Tuple[int, int]]
    E: int
    warm_tuple: Optional[tuple] = None
    duals_tuple: Optional[tuple] = None
    root_warm_tuple: Optional[tuple] = None
    margin_np: Optional[np.ndarray] = None
    # (margin_state, has_margin) when the caller threads a margin chain: the
    # anchor refresh happens at decode (it needs this solve's y-profile).
    margin_ctx: Optional[tuple] = None


def lane_input(arrays: MilpArrays, coeffs: HaldaCoeffs, kWs, feasible, warm=None,
               margin_state: Optional[dict] = None, per_k: bool = False) -> LaneInput:
    """Standard form, warm inputs, rounding data and the float32 device
    arrays of one sweep, on the host. ``margin_state`` (MoE, a warm tick
    with stored duals, not per-k) may supply pre-slackened root bounds."""
    sf = build_standard_form(arrays, coeffs, feasible)
    E = int(arrays.moe.E) if sf.moe else 0
    warm_tuple, duals_tuple, root_warm_tuple = warm_inputs(sf, warm, feasible, E)
    rd_np = rounding_arrays_np(coeffs, arrays.moe)
    margin_np = None
    if (margin_state is not None and sf.moe and warm_tuple is not None
            and duals_tuple is not None and not per_k):
        margin_np = margin_bounds_from_state(margin_state, rd_np, sf, duals_tuple)
    return LaneInput(
        sf=sf, host=device_arrays(sf, rd_np["g_raw"]), rd_np=rd_np, feasible=list(feasible),
        kWs=list(kWs), E=E, warm_tuple=warm_tuple, duals_tuple=duals_tuple,
        root_warm_tuple=root_warm_tuple, margin_np=margin_np,
        margin_ctx=((margin_state, margin_np is not None)
                    if margin_state is not None and sf.moe else None),
    )


def solve_sweep_torch(
    arrays: MilpArrays,
    kWs: Sequence[Tuple[int, int]],
    mip_gap: float = 1e-4,
    coeffs: Optional[HaldaCoeffs] = None,
    ipm_iters: Optional[int] = None,
    max_rounds: Optional[int] = None,
    beam: Optional[int] = None,
    node_cap: Optional[int] = None,
    debug: bool = False,
    warm: Optional[ILPResult] = None,
    timings: Optional[dict] = None,
    ipm_warm_iters: Optional[int] = None,
    lp_backend: Optional[str] = None,
    pdhg_iters: Optional[int] = None,
    pdhg_restart_tol: Optional[float] = None,
    mesh_shards: Optional[int] = None,
    pdhg_dtype: Optional[str] = None,
    device=None,
    per_k_optima: bool = False,
    collect: bool = True,
    margin_state: Optional[dict] = None,
    convergence: Optional[dict] = None,
):
    """Solve the whole k-sweep on ``device`` (None = cuda).

    Returns ``(per_k_results, best)``: one entry per (k, W) pair carrying
    that k's best incumbent objective (reporting-only, ``w``/``n`` None for
    the losing k's), and the global optimum with its assignment (``y`` in
    MoE mode) and the mip-gap certificate (``certified``/``gap``). Ks with
    W < M are None. A solve that misses the certificate warns
    (``RuntimeWarning``) and returns ``certified=False`` with the achieved
    gap. ``timings`` receives ``build_sf_ms``, ``upload_ms``, ``solve_ms``,
    ``ipm_iters_executed`` (LP iterations of either engine),
    ``bnb_rounds`` and, in MoE mode, ``decomp_steps`` and ``decomp_ms``;
    the chosen engine is echoed as ``lp_backend`` and the shard count as
    ``mesh_shards``. ``pdhg_iters``/``pdhg_restart_tol``/``pdhg_dtype`` set
    the PDHG engine's budget, restart factor and iterate precision (a MoE
    sweep runs it through K5's per-element entry); ``mesh_shards`` above 1
    row-partitions every LP relaxation of every round over that many shards
    (K6b, :func:`~distilp_torch.parallel.devices.shard_mesh` on ``device``'s
    type; MoE nodes through its per-element entry).

    ``per_k_optima=True`` prunes every node against its own k's incumbent
    (K3's per-k mode): every feasible k ends with its own certified optimum
    and full assignment, each entry an ``ILPResult`` (a k whose subtree was
    exhausted reports gap = ``mip_gap``; one never explored is uncertified
    with gap None, and a ``RuntimeWarning`` names the k's that missed).

    ``margin_state`` (a dict the caller threads across MoE streaming ticks)
    turns on the margin fast path: a warm tick whose drift stayed in the
    reusable class takes its root bounds from
    :func:`margin_bounds_from_state` instead of K7; a full evaluation
    refreshes the anchor in the dict when the sweep is decoded, and
    ``margin_state['used']`` reports which the tick was.

    ``convergence`` (a dict, emptied first) turns on the solver's
    convergence telemetry: the search logs every executed round and runs the
    root round's LP with its convergence trace (B13), and the decode fills
    the dict with the reference's keys (``lp_backend``, ``mip_gap``, ``ks``,
    ``incumbent``, ``best_bound``, ``ipm_iters_executed``, ``bnb_rounds``,
    ``round_log``, ``root_trace``; plain lists, see
    ``distilp_torch.obs.convergence``) and puts the ``conv_*`` digest into
    ``timings``. The search itself is the untraced one.

    ``collect=False`` returns a :class:`PendingSweep` once the instance is
    built and uploaded: the search runs on a worker thread (on a CUDA stream
    of its own) and :func:`collect_sweep` redeems it (and decodes the
    convergence dict). A structurally infeasible sweep still returns the
    plain ``(results, None)``.
    """
    if convergence is not None:
        convergence.clear()  # one solve, one report
    if coeffs is None:
        raise ValueError("solve_sweep_torch requires the HaldaCoeffs used for assembly")
    M = arrays.layout.M
    feasible = [(k, W) for (k, W) in kWs if W >= M]
    if not feasible:
        return [None] * len(kWs), None
    dev = resolve_device(device)
    t0 = time.perf_counter()
    lane = lane_input(arrays, coeffs, kWs, feasible, warm, margin_state, per_k_optima)
    params = _search_params(lane.sf, node_cap, beam, ipm_iters, max_rounds, ipm_warm_iters,
                            lp_backend, pdhg_iters, mesh_shards, pdhg_dtype, per_k_optima,
                            pdhg_restart_tol)
    row_mesh = None
    if params["mesh_shards"] > 1:
        row_mesh = shard_mesh(params["mesh_shards"], dev)
    if timings is not None:
        timings["lp_backend"] = params["lp_backend"]
        timings["mesh_shards"] = params["mesh_shards"]
    t1 = time.perf_counter()
    prep = _prepare([lane], params, mip_gap, dev, debug=debug, per_k=per_k_optima,
                    timings=timings, shared_A=True, convergence=convergence,
                    row_mesh=row_mesh)
    prep.stats["build_sf_ms"] = (t1 - t0) * 1e3
    if not collect:
        return PendingSweep(prep)
    return _decode_sweep(prep, _search(prep), 0)


solve_sweep_torch = _instrument("solver.solve_sweep", solve_sweep_torch)


def _search_params(sf: StandardForm, node_cap, beam, ipm_iters, max_rounds, ipm_warm_iters,
                   lp_backend, pdhg_iters, mesh_shards, pdhg_dtype, per_k,
                   pdhg_restart_tol=None) -> dict:
    """The resolved search parameters of a sweep."""
    (
        cap, beam, ipm_iters, ipm_warm_iters, max_rounds, engine, mesh_shards,
        pdhg_dtype,
    ) = resolve_search_params(
        sf.moe, len(sf.ks), node_cap, beam, ipm_iters, max_rounds,
        ipm_warm_iters=ipm_warm_iters, lp_backend=lp_backend,
        pdhg_iters=pdhg_iters, M=sf.M, mesh_shards=mesh_shards,
        pdhg_dtype=pdhg_dtype, per_k=per_k,
    )
    return dict(cap=cap, beam=beam, ipm_iters=ipm_iters, ipm_warm_iters=ipm_warm_iters,
                max_rounds=max_rounds, lp_backend=engine, mesh_shards=mesh_shards,
                pdhg_dtype=pdhg_dtype, pdhg_restart_tol=pdhg_restart_tol)


class _Prepared:
    """L sweeps built and uploaded, ready for their search: the static
    entry (A, its structure and values on the card), the dynamic blob's
    views (``views``), on the graph route the plan that owns them, the
    lane data and, built when first asked, the lanes' root state."""

    def __init__(self, lanes, mip_gap, debug, per_k, timings, data, loop_kw, moe_ctx, warm,
                 duals, margin, stats, convergence=None, views=None, root_warm=None,
                 entry=None, plan=None, cap=0, pinned=None):
        self.lanes: List[LaneInput] = lanes
        self.mip_gap = mip_gap
        self.debug = debug
        self.per_k = per_k
        self.timings: Optional[dict] = timings
        self.data: SweepData = data  # lane data
        self.loop_kw: dict = loop_kw
        self.moe_ctx: Optional[tuple] = moe_ctx  # (w_max, e_max, decomp_steps)
        self.warm: Optional[tuple] = warm  # (k index (L,), w, n, y (L, M)) on the device
        self.duals: Optional[tuple] = duals  # (lam (L, n_k), mu, tau (L, n_k, M)), numpy
        self.margin: Optional[torch.Tensor] = margin  # (L, n_k) pre-slackened root bounds
        self.stats: dict = stats
        # The caller's convergence dict (one sweep): the search logs its
        # rounds and the root round's LP trace, decoded into it.
        self.convergence: Optional[dict] = convergence
        self.views = views
        self.root_warm = root_warm  # (ok, v, y, z, f) views, or None
        self.entry = entry  # packed.StaticEntry
        self.plan = plan  # device_loop.LoopPlan on the graph route
        self.cap = cap
        self._pinned = pinned  # the upload's host buffer (host route)
        self._state: Optional[SearchState] = None

    @property
    def state(self) -> SearchState:
        """The lanes' root state (built on first use)."""
        if self._state is None:
            v = self.views
            self._state = root_state(v["lo_k"], v["hi_k"], self.lanes[0].sf.M, self.cap,
                                     v["b_k"].shape[-1], self.root_warm)
        return self._state

    def release(self) -> None:
        """Hand the plan and the upload's host buffer back."""
        release_plan(self.plan)
        self.plan = None
        packed.give_pinned(self._pinned)
        self._pinned = None

    def __del__(self):
        if self.plan is not None:  # a prepared sweep dropped unsearched
            self.plan.busy = False


def _prepare(lanes: List[LaneInput], params: dict, mip_gap: float, dev, debug=False,
             per_k=False, timings=None, shared_A=False, A_lanes=None,
             convergence: Optional[dict] = None, row_mesh=None,
             node_mesh=None, root_beam: Optional[int] = None,
             _host_loop: bool = False) -> _Prepared:
    """Upload L sweeps (same shapes and search parameters): their static
    half through the content-addressed cache (``packed.static_entry``; A's
    structure is built and checked there, once per entry) and their dynamic
    half as one blob in one copy. ``shared_A``: every lane has lane 0's A
    (scenarios of one fleet: one (m, nf) matrix); else ``A_lanes`` (L, m,
    nf) on the device (or a function making it, called on a static miss),
    or each lane's own A stacked. Warm hints, stored duals, root iterates
    and margin bounds are used only when every lane has them. ``convergence`` (one
    lane) turns on the round log and the root round's LP trace.
    ``row_mesh`` (one sweep on the PDHG engine) row-partitions every LP
    relaxation over its shards (K6b, its row blocks made once per static
    entry); ``node_mesh`` (a Mesh, one sweep) splits every round's rows
    over its shards (K10), the root round widened to ``root_beam`` rows.
    The route (``device_loop.loop_route``): a sweep on either engine, on a
    row or node mesh of the search's card too, with the round log or
    without, takes the graph route, whose plan owns the blob (on the PDHG
    with K5's route in its signature, on a mesh with its shards, with the
    log its ``diag``); a mesh over distinct cards keeps the host loop;
    ``_host_loop`` (the card's comparison) forces the host loop."""
    t1 = time.perf_counter()
    L = len(lanes)
    sf0 = lanes[0].sf
    M, moe = sf0.M, sf0.moe
    n_k = len(sf0.ks)
    m, nf = sf0.A.shape[1], sf0.A.shape[2]
    if A_lanes is None and (shared_A or L == 1):
        key, A_src = pack_static(sf0).tobytes(), lanes[0].host["A"]
    else:
        key = tuple(pack_static(ln.sf).tobytes() for ln in lanes)
        A_src = A_lanes if A_lanes is not None else np.stack([ln.host["A"] for ln in lanes])
    entry, _ = packed.static_entry(key, A_src, M, moe, dev)
    engine = params["lp_backend"]
    per_element = entry.per_element
    on_mesh = row_mesh is not None and row_mesh.size > 1
    # The PDHG reads A as values on its structure, except one shared A on a
    # row mesh, which K6b takes dense.
    pdhg_values = engine == "pdhg" and (per_element or not on_mesh)
    has_warm = all(ln.warm_tuple is not None for ln in lanes)
    use_root_warm = all(ln.root_warm_tuple is not None for ln in lanes)
    duals = moe_ctx = None
    has_margin = False
    if moe:
        if all(ln.duals_tuple is not None for ln in lanes):
            duals = tuple(np.stack([ln.duals_tuple[i] for ln in lanes]) for i in range(3))
        # The decomposition bound certifies wide-expert instances (their LP
        # root gap is structural). A warm tick with both the stored
        # multipliers and a warm incumbent only re-evaluates it, or, on the
        # margin path, takes the host's re-derived bounds.
        decomp_steps = (DECOMP_STEPS_WARM if duals is not None and has_warm
                        else DECOMP_STEPS_COLD)
        has_margin = (decomp_steps == DECOMP_STEPS_WARM
                      and all(ln.margin_np is not None for ln in lanes))
        moe_ctx = (max(W for _, W in lanes[0].feasible), lanes[0].E, decomp_steps)
    route, why = loop_route(moe, engine, row_mesh, convergence is not None, node_mesh, dev)
    if route == "graph" and (_host_loop or forced_host_loop()):
        route, why = "host", "host_loop_asked" + ("+log" if convergence is not None else "")
    note_route(route, why, L)
    lp_dt = resolve_pdhg_dtype(params["pdhg_dtype"]) or torch.float32
    plan = pinned = None
    if route == "graph":
        want_my = moe and not has_margin and any(ln.margin_ctx is not None for ln in lanes)
        # On the PDHG, K5's route from the entry's structure before the plan
        # is taken: it is part of the plan's signature (a row mesh's LP is
        # K6b's, whose group size and row blocks are).
        pdhg = mesh = None
        if on_mesh:
            mesh = row_mesh_plan(entry, dev, row_mesh.size, lp_dt == torch.float64)
            rt = params["pdhg_restart_tol"]
            pdhg = (lp_dt == torch.float64, DEFAULT_RESTART_TOL if rt is None else float(rt),
                    "", 0, 0, 0)
        elif engine == "pdhg":
            pdhg = pdhg_plan(entry, dev, params["pdhg_dtype"], params["pdhg_restart_tol"])
        if node_mesh is not None:
            mesh = ("node", node_mesh.size, n_k if root_beam is None else root_beam)
        plan = acquire_plan(plan_sig(
            dev, L, params["cap"], n_k, params["beam"], m, nf, M, per_k, params["ipm_iters"],
            params["ipm_warm_iters"], use_root_warm, mip_gap, params["max_rounds"], has_warm,
            use_root_warm, entry, moe_ctx, duals is not None, has_margin, want_my, pdhg, mesh,
            diag=convergence is not None))
        plan.stage(lanes)
        views = plan.views
    else:
        layout = packed.dyn_layout(L, n_k, m, nf, M, moe, has_warm, use_root_warm, has_margin)
        pinned = packed.take_pinned(layout.nbytes, dev)
        packed.pack_dynamic(lanes, layout, pinned.numpy())
        views = packed.dyn_views(packed.upload(pinned, dev), layout)
    if plan is not None:
        data = plan.data(entry)
    else:
        A_sparsity = A_values = gky_pos = A_shards = None
        if engine == "ipm" or pdhg_values:
            A_sparsity = entry.sparsity
        if pdhg_values:
            A_values, gky_pos = entry.pdhg_values()
        if on_mesh:
            # K6b's row blocks, kept on the static entry: a per-element A's
            # structure by block, or the shared A's dense blocks and their
            # transposes in the iterate dtype.
            A_shards = entry.mesh_blocks(row_mesh.size, None if per_element else lp_dt)
        data = SweepData(
            A=entry.A, b_k=views["b_k"], c_k=views["c_k"], int_mask=views["int_mask"],
            ks=views["ks"], Ws=views["Ws"], obj_const=views["obj_const"],
            rd=packed.rounding_views(views), rd_packed=views["rd"], gky=views.get("gky"),
            A_sparsity=A_sparsity, A_values=A_values, gky_pos=gky_pos, A_shards=A_shards,
            A_k1_values=entry.values if entry.A.dim() == 2 else None, A_checked=True,
        )
    root_warm = None
    if use_root_warm:
        root_warm = tuple(views[k] for k in ("rw_ok", "rw_v", "rw_y", "rw_z", "rw_f"))
    warm = None
    if has_warm:
        warm = tuple(views[k] for k in ("warm_kidx", "warm_w", "warm_n", "warm_y"))
    margin = views["margin"] if has_margin else None
    loop_kw = dict(
        ipm_iters=params["ipm_iters"], max_rounds=params["max_rounds"], beam=params["beam"],
        ipm_warm_iters=params["ipm_warm_iters"], root_warm_chunk=use_root_warm,
        lp_backend=engine, pdhg_restart_tol=params["pdhg_restart_tol"],
        pdhg_dtype=params["pdhg_dtype"], per_k=per_k,
        collect_rounds=convergence is not None, row_mesh=row_mesh,
    )
    if node_mesh is not None and plan is None:
        loop_kw.update(node_mesh=node_mesh_of(node_mesh, data), root_beam=root_beam)
    stats = {"upload_ms": (time.perf_counter() - t1) * 1e3}
    return _Prepared(lanes=lanes, mip_gap=mip_gap, debug=debug, per_k=per_k,
                     timings=timings, data=data, loop_kw=loop_kw, moe_ctx=moe_ctx, warm=warm,
                     duals=duals, margin=margin, stats=stats, convergence=convergence,
                     views=views, root_warm=root_warm, entry=entry, plan=plan,
                     cap=params["cap"], pinned=pinned)


def seeded_state(prep: _Prepared):
    """The root state of L prepared sweeps seeded for their search: the MoE
    root bounds (one K7 ascent over every lane, or the margin bounds) and
    the warm incumbents. Returns ``(state, duals, raw_bounds, m_y,
    t_decomp)``, the last the host clock after the bounds were enqueued."""
    data, state = prep.data, prep.state
    dev = data.ks.device
    sf = prep.lanes[0].sf
    duals_t = raw_bounds = m_y = None
    if prep.moe_ctx is not None:
        w_max, E, decomp_steps = prep.moe_ctx
        problems = [None, None]
        if prep.margin is None:
            problems = [
                stack_problems([decomp_problem(ln.rd_np, ln.sf.ks, ln.sf.Ws, w_max, E, dt, dev)
                                for ln in prep.lanes])
                for dt in (torch.float32, torch.float64)
            ]
        init = prep.duals
        state, duals_t, raw_bounds, m_y = seed_root_bounds(
            state, data, *problems, decomp_steps, init_duals=init, margin=prep.margin
        )
        if prep.margin is not None:
            duals_t = tuple(torch.as_tensor(d, dtype=BDTYPE, device=dev) for d in init)
    t_decomp = time.perf_counter()
    if prep.warm is not None:
        state = seed_warm(state, data, prep.warm, sf.moe, MOE_LOCAL_MOVES_WARM)
    return state, duals_t, raw_bounds, m_y, t_decomp


def host_answer(prep: _Prepared, state: SearchState, root_iters, log, duals_t=None,
                raw_bounds=None, m_y=None):
    """The host loop's (L, width) answer on the device and its layout: the
    searched ``state``'s rows (``device_loop.answer_rows``), then the margin
    anchor ``m_y`` where a lane asks for it, then ``run_bnb_loop``'s round
    log, padded to ``max_rounds`` zero rows (the graph's layout, so the two
    routes' answers compare byte for byte), and the first n_k roots'
    trace."""
    data = prep.data
    L, n_k = data.ks.shape
    sf = prep.lanes[0].sf
    m, nf = sf.A.shape[1], sf.A.shape[2]
    extra, my_shape, conv_rows, trace_shape = [], (), 0, ()
    if m_y is not None and any(ln.margin_ctx is not None for ln in prep.lanes):
        extra.append(m_y)
        my_shape = tuple(m_y.shape[1:])
    if log is not None:
        rows, root_trace = log
        conv_rows = prep.loop_kw["max_rounds"]
        rl = torch.zeros((conv_rows, L, RL_COLS), dtype=BDTYPE, device=data.ks.device)
        if rows:
            rl[:len(rows)] = torch.stack(rows)
        tr = root_trace[:, :n_k]
        trace_shape = tuple(tr.shape[1:])
        extra += [rl.transpose(0, 1), tr]
    lay = packed.AnswerLayout(sf.M, n_k, m, nf, duals_t is not None, prep.per_k, my_shape,
                              conv_rows, trace_shape)
    return answer_rows(state, root_iters, n_k, prep.per_k, duals_t, raw_bounds, extra), lay


def _search(prep: _Prepared) -> dict:
    """The device half of L sweeps and one read-back of what the decode
    needs: on the graph route one launch of the plan's graph (the seed, the
    loop and the answer on the card); on the host route the MoE root bounds
    (one ascent over every lane), the warm incumbents and
    ``search.run_bnb_loop``, the answer assembled on the card."""
    data = prep.data
    t2 = time.perf_counter()
    stats = {}
    try:
        if prep.plan is not None:
            plan = prep.plan
            ans = plan.run(prep.entry, prep.warm, prep.root_warm)
            lay = plan.alay
            if prep.moe_ctx is not None:
                stats.update(decomp_steps=prep.moe_ctx[2])
        else:
            state, duals_t, raw_bounds, m_y, t_decomp = seeded_state(prep)
            state, root_iters, log = run_bnb_loop(data, state, prep.mip_gap, **prep.loop_kw)
            ans, lay = host_answer(prep, state, root_iters, log, duals_t, raw_bounds, m_y)
            ans = packed.read_answer(ans)
            if prep.moe_ctx is not None:
                # Host time to enqueue the bound (the ascent reads nothing back).
                stats.update(decomp_steps=prep.moe_ctx[2],
                             decomp_enqueue_ms=(t_decomp - t2) * 1e3)
    finally:
        prep.release()
    out = packed.split_answer(ans, lay)
    stats["solve_ms"] = (time.perf_counter() - t2) * 1e3
    out.update(stats=stats, has_duals=lay.has_duals)
    if out["m_y"] is None or not any(ln.margin_ctx is not None for ln in prep.lanes):
        out["m_y"] = None
    return out


def _decode_sweep(prep: _Prepared, out: dict, q: int):
    """``(results, best)`` of lane ``q`` from a search's read-back (host
    only); refreshes the lane's margin anchor."""
    lane = prep.lanes[q]
    results: List[Optional[ILPResult]] = [None] * len(lane.kWs)
    sf = lane.sf
    M, n_k, moe = sf.M, len(sf.ks), sf.moe
    head = out["head"][q]
    stats = {**prep.stats, **out["stats"], "ipm_iters_executed": float(head[3]),
             "bnb_rounds": float(head[4])}
    if prep.timings is not None and len(prep.lanes) == 1:
        prep.timings.update(stats)
    incumbent, bound = float(head[0]), float(head[1])
    if prep.debug:
        print(
            f"    [torch] incumbent={incumbent:.6f} bound={bound:.6f} "
            f"ipm_iters={head[3]:.0f} rounds={head[4]:.0f} "
            f"solve={stats['solve_ms']:.2f}ms"
        )
    o = 5
    inc_w = [int(round(x)) for x in head[o : o + M]]
    inc_n = [int(round(x)) for x in head[o + M : o + 2 * M]]
    inc_y = [int(round(x)) for x in head[o + 2 * M : o + 3 * M]] if moe else None
    o += 3 * M
    per_k_best = head[o : o + n_k]
    o += n_k
    out_duals = None
    if out["has_duals"]:
        # Persisted on the winning result: the next tick re-evaluates the
        # bound at these multipliers (the JAX package reads the same keys).
        out_duals = {
            "lam": head[o : o + n_k].tolist(),
            "mu": head[o + n_k : o + 2 * n_k].tolist(),
            "tau": head[o + 2 * n_k : o + 2 * n_k + n_k * M].reshape(n_k, M).tolist(),
            "root_bounds": head[o + 2 * n_k + n_k * M : o + 3 * n_k + n_k * M].tolist(),
        }
        o += 3 * n_k + n_k * M
    pk = None
    if prep.per_k:
        blk = n_k * M
        pk = (head[o : o + blk].reshape(n_k, M), head[o + blk : o + 2 * blk].reshape(n_k, M),
              head[o + 2 * blk : o + 3 * blk].reshape(n_k, M),
              head[o + 3 * blk : o + 3 * blk + n_k])
    best = _decode_best(prep, out, q, results, incumbent, bound, per_k_best, pk,
                        (inc_w, inc_n, inc_y), out_duals)
    _refresh_margin(lane, best, out["m_y"], q)
    if prep.convergence is not None:
        _decode_convergence(prep, out, q)
    return results, best


def _decode_convergence(prep: _Prepared, out: dict, q: int) -> None:
    """Lane ``q``'s round log and root LP trace into the caller's
    convergence dict, in the reference's keys and plain-list layout
    (``_decode_convergence``); the ``conv_*`` digest into ``timings``."""
    from ..obs.convergence import build_search_trace

    lane = prep.lanes[q]
    head = out["head"][q]
    rl, rtr = out["conv"][0][:, q], out["conv"][1][q]
    conv = prep.convergence
    conv.update(
        lp_backend=prep.loop_kw["lp_backend"],
        mip_gap=float(prep.mip_gap),
        ks=[k for k, _ in lane.feasible],
        incumbent=float(head[0]),
        best_bound=float(head[1]),
        ipm_iters_executed=float(head[3]),
        bnb_rounds=float(head[4]),
        # Executed rounds only, each prefixed with its round index (0 is
        # the root round).
        round_log=[[int(i)] + [float(v) for v in rl[i, : RL_COLS - 1]]
                   for i in range(rl.shape[0]) if rl[i, RL_COLS - 1] > 0.5],
        root_trace=[[list(map(float, r)) for r in el] for el in rtr],
    )
    if prep.timings is not None:
        prep.timings.update(build_search_trace(conv).digest())


def _decode_best(prep, out, q, results, incumbent, bound, per_k_best, pk, inc, out_duals):
    """Fill lane ``q``'s per-k ``results`` and return its optimum (None
    when no k found an incumbent)."""
    lane = prep.lanes[q]
    feasible, mip_gap, moe = lane.feasible, prep.mip_gap, lane.sf.moe
    if not np.isfinite(incumbent):
        if pk is not None and not np.all(np.isposinf(pk[3])):
            # Budget starvation (some subtree left), not proven infeasibility.
            warnings.warn(
                "HALDA per-k sweep: NO k found an incumbent within the round "
                "budget (all entries omitted: budget starvation, not proven "
                "infeasibility); raise max_rounds.",
                RuntimeWarning,
                stacklevel=4,
            )
        return None

    gap = (incumbent - bound) / abs(incumbent) if incumbent != 0.0 else incumbent - bound
    gap = max(0.0, gap)
    is_cert = incumbent - bound <= mip_gap * abs(incumbent) + 1e-12
    if not is_cert:
        warnings.warn(
            f"HALDA torch backend: mip-gap certificate NOT met "
            f"(incumbent={incumbent:.6g}, bound={bound:.6g}, achieved "
            f"gap={gap:.3g}, requested {mip_gap:g}); raise "
            f"halda_solve(max_rounds=..., node_cap=...) or relax mip_gap. "
            f"The result carries certified=False and the achieved gap.",
            RuntimeWarning,
            stacklevel=4,
        )
    inc_k_idx = int(out["head"][q][2])
    ok_r, v_r, y_r, z_r, f_r = (r[q] for r in out["root"])
    ipm_state = None
    if np.any(ok_r > 0.5):
        ipm_state = {"ok": ok_r > 0.5, "v": v_r, "y": y_r, "z": z_r, "f": f_r}
    inc_w, inc_n, inc_y = inc
    best: Optional[ILPResult] = None
    pos_of = {kW: i for i, kW in enumerate(lane.kWs)}
    for j, (k, W) in enumerate(feasible):
        obj_j = float(per_k_best[j])
        if not np.isfinite(obj_j):
            continue
        if pk is not None:
            entry = _per_k_entry(k, j, obj_j, pk, moe, mip_gap)
            if j == inc_k_idx:
                entry = entry.model_copy(update={"duals": out_duals, "ipm_state": ipm_state})
                best = entry
            results[pos_of[(k, W)]] = entry
        elif j == inc_k_idx:
            best = ILPResult(
                k=k, w=inc_w, n=inc_n, y=inc_y, obj_value=obj_j, certified=is_cert,
                gap=gap, duals=out_duals, ipm_state=ipm_state,
            )
            results[pos_of[(k, W)]] = best
        else:
            results[pos_of[(k, W)]] = ILPResult(k=k, obj_value=obj_j, certified=False)
    if pk is not None:
        _warn_per_k(results, feasible, per_k_best, pk[3])
    return best


def _refresh_margin(lane: LaneInput, best: Optional[ILPResult], m_y, q: int) -> None:
    """The margin chain at decode: a margin tick keeps its fixed anchor; a
    full evaluation makes this solve's y-profile, rounding data, k grid and
    multipliers the anchor; anything else drops it."""
    if lane.margin_ctx is None:
        return
    margin_state, has_margin = lane.margin_ctx
    margin_state["used"] = has_margin
    if has_margin:
        return
    if best is not None and best.duals is not None and "root_bounds" in best.duals \
            and m_y is not None:
        margin_state.update(
            rd=lane.rd_np,
            ks=np.asarray(lane.sf.ks, np.float64),
            Ws=np.asarray(lane.sf.Ws, np.float64),
            m_y=m_y[q],
            duals=tuple(np.asarray(best.duals[f], np.float64) for f in ("lam", "mu", "tau")),
        )
    else:
        margin_state.pop("m_y", None)
        margin_state.pop("duals", None)


def solve_sweep_scenarios(
    arrays_list: Sequence[MilpArrays],
    kWs: Sequence[Tuple[int, int]],
    coeffs_list: Sequence[HaldaCoeffs],
    mip_gap: float = 1e-4,
    warms: Optional[Sequence[Optional[ILPResult]]] = None,
    ipm_iters: Optional[int] = None,
    max_rounds: Optional[int] = None,
    beam: Optional[int] = None,
    node_cap: Optional[int] = None,
    timings: Optional[dict] = None,
    ipm_warm_iters: Optional[int] = None,
    lp_backend: Optional[str] = None,
    pdhg_iters: Optional[int] = None,
    pdhg_restart_tol: Optional[float] = None,
    mesh_shards: Optional[int] = None,
    pdhg_dtype: Optional[str] = None,
    device=None,
) -> List[Tuple[List[Optional[ILPResult]], Optional[ILPResult]]]:
    """Solve S what-if scenarios of one fleet as S lanes of one search.

    Scenarios are profile-drift variants of one instance (t_comm futures,
    load factors) whose static half (:func:`pack_static`: base A,
    structural objective, boxes, slack minima) is byte-identical: they
    share one A on the device, and every round runs all S lanes' rows in
    one LP call, one rounding and one epilogue launch (a MoE batch runs one
    K7 ascent over the S instances). Scenarios whose static half differs
    raise ValueError (``halda_solve_scenarios`` then takes the batch-layout
    fallback). ``warms`` seeds each scenario; warm hints, MoE duals and root
    iterates engage only when EVERY scenario has them, else all run cold.
    ``mesh_shards`` is accepted and not used (the lanes are the batch).
    Returns one ``(per_k_results, best)`` per scenario, the contract of
    :func:`solve_sweep_torch`; ``timings`` gets ``build_sf_ms``,
    ``upload_ms``, ``solve_ms``, ``scenarios``, ``bnb_rounds`` (the most
    any lane ran) and ``lp_backend``."""
    S = len(arrays_list)
    if S == 0:
        return []
    if len(coeffs_list) != S or (warms is not None and len(warms) != S):
        raise ValueError("arrays_list/coeffs_list/warms lengths must match")
    M = arrays_list[0].layout.M
    feasible = [(k, W) for (k, W) in kWs if W >= M]
    if not feasible:
        return [([None] * len(kWs), None) for _ in range(S)]
    dev = resolve_device(device)
    t0 = time.perf_counter()
    lanes = [lane_input(a, c, kWs, feasible, warms[i] if warms is not None else None)
             for i, (a, c) in enumerate(zip(arrays_list, coeffs_list))]
    static0 = pack_static(lanes[0].sf)
    for i, ln in enumerate(lanes[1:], start=1):
        if not np.array_equal(pack_static(ln.sf), static0):
            raise ValueError(
                f"scenario {i}'s packed static half differs from scenario 0's, so they "
                f"cannot share one A: device speed/memory/fleet/model changes, or a "
                f"t_comm/load excursion large enough to move a row's scaling. Solve the "
                f"scenarios as separate sweeps (or through the batch layout) instead"
            )
    params = _search_params(lanes[0].sf, node_cap, beam, ipm_iters, max_rounds,
                            ipm_warm_iters, lp_backend, pdhg_iters, mesh_shards, pdhg_dtype,
                            False, pdhg_restart_tol)
    t1 = time.perf_counter()
    prep = _prepare(lanes, params, mip_gap, dev, shared_A=True)
    out = _search(prep)
    decoded = [_decode_sweep(prep, out, q) for q in range(S)]
    if timings is not None:
        timings.update(build_sf_ms=(t1 - t0) * 1e3, upload_ms=prep.stats["upload_ms"],
                       solve_ms=out["stats"]["solve_ms"], scenarios=float(S),
                       bnb_rounds=float(out["head"][:, 4].max()),
                       ipm_iters_executed=float(out["head"][:, 3].sum()),
                       lp_backend=params["lp_backend"])
        if prep.moe_ctx is not None:
            timings["decomp_steps"] = prep.moe_ctx[2]
    return decoded


solve_sweep_scenarios = _instrument("solver.solve_sweep_scenarios", solve_sweep_scenarios)


def _per_k_entry(k: int, j: int, obj_j: float, pk, moe: bool, mip_gap: float) -> ILPResult:
    """Per-k mode: the full entry of k (index j). A bound of +inf means its
    subtree was exhausted or pruned at the gap threshold (certified, with
    the gap the pruning allowed); -inf means it was never explored (no
    certificate)."""
    pk_w, pk_n, pk_y, pk_bound = pk
    bound_j = float(pk_bound[j])
    if np.isposinf(bound_j):
        cert_j, gap_j = True, mip_gap
    elif not np.isfinite(bound_j):
        cert_j, gap_j = False, None
    else:
        gap_j = max(0.0, (obj_j - bound_j) / abs(obj_j) if obj_j != 0.0 else obj_j - bound_j)
        cert_j = obj_j - bound_j <= mip_gap * abs(obj_j) + 1e-12
    return ILPResult(
        k=k,
        w=[int(round(x)) for x in pk_w[j]],
        n=[int(round(x)) for x in pk_n[j]],
        y=[int(round(x)) for x in pk_y[j]] if moe else None,
        obj_value=obj_j,
        certified=cert_j,
        gap=gap_j,
    )


def _warn_per_k(results, feasible, per_k_best, pk_bound) -> None:
    """Name the k's of a per-k sweep that missed their own certificate, and
    those the round budget never reached (omitted, not infeasible)."""
    missed = [r.k for r in results if r is not None and r.w is not None and not r.certified]
    unexplored = [
        k for j, (k, _) in enumerate(feasible)
        if not np.isfinite(float(per_k_best[j])) and not np.isposinf(float(pk_bound[j]))
    ]
    if not (missed or unexplored):
        return
    parts = []
    if missed:
        parts.append(
            f"certificate NOT met for k={missed} (budget exhausted before those "
            f"k's closed their own gap)"
        )
    if unexplored:
        parts.append(
            f"k={unexplored} never explored (no incumbent found before the round "
            f"budget ran out; these are OMITTED, not infeasible)"
        )
    warnings.warn(
        f"HALDA per-k sweep: {'; '.join(parts)}; raise max_rounds.",
        RuntimeWarning,
        stacklevel=4,
    )


# The one thread that runs dispatched searches, in dispatch order. It stays
# warm: a fresh thread per dispatch paid for its first CUDA calls each time
# (3-4 ms a north-star search on an H100, against 6-8 ms of search).
_SEARCH_WORKER = ThreadPoolExecutor(max_workers=1, thread_name_prefix="distilp-search")


def _search_on(prep: _Prepared, stream, entries) -> dict:
    # The dispatching entry points' names ride along, so that a graph the
    # search captures here is billed to them (obs.compile_ledger).
    with _compile_ledger.attributed(entries):
        if stream is None:
            return _search(prep)
        with torch.cuda.stream(stream):
            return _search(prep)


class PendingSweep:
    """A sweep dispatched by ``solve_sweep_torch(collect=False)``: built and
    uploaded on the caller's thread, searched on the search worker thread
    (on a CUDA stream of its own, ordered after the caller's uploads).
    Redeem it with :func:`collect_sweep`."""

    def __init__(self, prep: _Prepared):
        self._prep = prep
        dev = prep.data.ks.device
        stream = None
        if dev.type == "cuda":
            stream = torch.cuda.Stream(device=dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
        self._future = _SEARCH_WORKER.submit(_search_on, prep, stream,
                                             _compile_ledger.entry_stack())


def collect_sweep(pending: PendingSweep):
    """Wait for a dispatched sweep and decode it: the ``(results, best)`` of
    ``solve_sweep_torch``; the search's exception, if it raised, is raised
    here. A margin chain's anchor is refreshed here."""
    return _decode_sweep(pending._prep, pending._future.result(), 0)
