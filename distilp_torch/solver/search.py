"""Batched branch-and-bound over the whole k-sweep, driven from the host.

Each round solves the LP relaxations of the best-bound-first prefix of the
frontier in one batched LP call (the IPM, kernel K1, or at fleet scale the
PDHG engine, kernel K5); everything after it is the round tail
(:func:`round_tail`, one launch of ``round_tail_kernel.cu`` on a card):
it rounds every LP point to an exact integer incumbent (K2's per-row body;
MoE rows go through K2's MoE mode first), takes the incumbent, each k's
best and the prune threshold, runs K3's per-row epilogue (bound fold,
pruning, reduced-cost box tightening, closing, branching, child boxes, warm
carry), compacts the children best-bound-first and writes each lane's go
flag. One global incumbent prunes across every k's tree, since the answer
is the minimum over k. In per-k mode (``per_k=True``) a node prunes
against its own k's incumbent instead, and the same one launch also keeps
each k's incumbent assignment, its prune threshold, a k-fair compaction
order and each k's overflow floor (B15's per-k bodies), and its go flag
tests every k's own certificate, so that every k ends with its own.

Lanes: the search runs L sweeps at once (the scenarios of one fleet that
share its A, or batch lanes with an A each; the reference's vmap of the
whole search, B12). Every array of :class:`SearchState` and
:class:`SweepData` carries a leading lane axis; a round sends all lanes'
beam rows through one K1 (or K5) call and one round tail (one block a
lane), each row reading its own lane's data; the incumbent update is a
per-lane argmin and the compaction a per-lane stable order.
A lane that has settled is frozen, as under the reference's vmapped
``while_loop``: its rows go to the LP as ``skip`` and its state is carried
through unchanged. One sweep is the L = 1 case of the same code.

Nodes with an A of their own (MoE nodes, whose k's expert-busy entries sit
in A; lanes with an A each) go to K1 as dense per-node matrices
(:func:`node_A`) and to the PDHG's per-element entry (B11) as values on the
sweep's sparse structure (:func:`node_values`: each lane's values gathered
once per sweep, a MoE row's 2M entries written at their places).
``run_bnb_loop(collect_rounds=True)`` logs one row per executed round and
the root round's LP convergence trace (B13), read only at decode.

Ported from ``distilp_tpu/solver/backend_jax.py`` (``SearchState``,
``SweepData``, ``_root_state``, the IPM and single-device PDHG branches of
``_bnb_round`` with its MoE A scatter and its per-k mode, ``RL_COLS``,
``_round_row``, ``_root_trace_rows``,
``_seed_root_bounds``, ``_cast_lp_result``, ``_best_bound``, ``_certified``,
the mesh branch of ``_bnb_round`` (the row-sharded PDHG, ``mesh_shards``), the
node-sharded frontier of ``distilp_tpu/parallel/mesh.py`` (:class:`NodeMesh`),
``_per_k_bound``, ``_certified_per_k``, ``_run_bnb_loop``, and their vmap
in ``_solve_scenarios_packed``/``_solve_batched``).
MoE sweeps seed the roots with the Lagrangian decomposition bounds (K7, all
lanes in one ascent) and an incumbent repaired from the Lagrangian primal,
or, on a margin tick, with bounds re-derived on the host. The reference runs
the loop as one device program; so does the port (``device_loop``: one
CUDA graph a solve on either engine, dense or MoE, on a row or node mesh of
one card too); here is the host loop, which reads the lanes' go flags,
which the round tail writes, from the device once per round: the route of
the convergence log, of meshes over distinct cards and of the card's
comparison (``device_loop.host_loop``), and the plain versions the graph's
plan runs on the CPU.

Precision: search arrays and IPM iterations are float32; everything the
mip-gap certificate touches (bounds, incumbents, thresholds) is float64.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from .. import kernels
from ..ops.decomp import decomp_bound_roots
from ..ops.ipm import (
    IPM_DEFAULT_CHUNK,
    TRACE_COLS,
    IPMResult,
    IPMSparsity,
    IPMWarmState,
    LPBatch,
    ipm_solve_batch,
    ipm_sparsity,
    n_trace_rows,
)
from ..ops.meshlp import DenseBlocks, RowBlocks, sharded_pdhg
from ..ops.pdhg import (
    DEFAULT_RESTART_TOL,
    PDHG_DEFAULT_CHUNK,
    ElemA,
    _default_tol_pdhg,
    cast_batch,
    pdhg_solve_batch,
    resolve_pdhg_dtype,
)
from ..parallel.devices import Mesh
from .rounding import RoundingData, round_to_incumbent
from .standard_form import FRAC_TOL, IPM_ITERS, MAX_ROUNDS

DTYPE = torch.float32  # search arrays + IPM iteration dtype
BDTYPE = torch.float64  # certificate dtype
EPILOGUE_THREADS = 256
PER_K_THREADS = 256  # K3's per-k incumbent entry: one warp per k
PER_K_RANK_THREADS = 512  # K3's per-k rank entry: tiles of the child rows


class SearchState(NamedTuple):
    """The search of L lanes (shapes below after the leading (L,))."""

    node_lo: torch.Tensor  # (cap, nf) float32
    node_hi: torch.Tensor  # (cap, nf) float32
    node_kidx: torch.Tensor  # (cap,) int32
    node_bound: torch.Tensor  # (cap,) float64 parent bound (full objective)
    active: torch.Tensor  # (cap,) bool
    incumbent: torch.Tensor  # () float64 full-objective incumbent
    inc_w: torch.Tensor  # (M,) float64
    inc_n: torch.Tensor  # (M,) float64
    inc_y: torch.Tensor  # (M,) float64 (zeros in dense mode)
    inc_kidx: torch.Tensor  # () int32
    dropped_bound: torch.Tensor  # () float64 min bound of overflow-dropped nodes
    per_k_best: torch.Tensor  # (n_k,) float64 best incumbent per k
    per_k_w: torch.Tensor  # (n_k, M) float64
    per_k_n: torch.Tensor  # (n_k, M) float64
    per_k_y: torch.Tensor  # (n_k, M) float64
    per_k_dropped: torch.Tensor  # (n_k,) float64
    # Per-node IPM iterates (original coordinates): children warm-start from
    # their parent's point; node_warm gates rows that carry one.
    node_v: torch.Tensor  # (cap, nf) float32
    node_y: torch.Tensor  # (cap, m) float32
    node_z: torch.Tensor  # (cap, nf) float32
    node_f: torch.Tensor  # (cap, nf) float32
    node_warm: torch.Tensor  # (cap,) bool
    stat_ipm_iters: torch.Tensor  # () float64 IPM iterations executed
    stat_rounds: torch.Tensor  # () float64 rounds executed


class SweepData(NamedTuple):
    """Device-resident arrays of L sweeps, shared by every round (shapes
    after the leading (L,))."""

    # (m, nf) float32 shared by every k (the MoE base): one A for every lane
    # (scenarios of one fleet), or (L, m, nf), one per lane.
    A: torch.Tensor
    b_k: torch.Tensor  # (n_k, m) float32
    c_k: torch.Tensor  # (n_k, nf) float32
    int_mask: torch.Tensor  # (nf,) bool
    ks: torch.Tensor  # (n_k,) float64
    Ws: torch.Tensor  # (n_k,) float64
    obj_const: torch.Tensor  # () float64
    rd: RoundingData  # (M,) vectors; bprime, E ()
    rd_packed: Optional[torch.Tensor] = None  # rounding.pack_rounding_data(rd)
    # MoE: the per-k expert-busy entries of A (standard_form.gky_scatter_table),
    # scattered onto each node's copy of the base at rows 4M..6M, columns
    # 2M..3M. None in dense mode (A is k-free).
    gky: Optional[torch.Tensor] = None  # (n_k, 2, M) float32
    # The structure of every node's A (node_sparsity; for lanes with an A
    # each, the union over the lanes), built once per sweep for K1 and for
    # K5; None builds it per call (K1) or, for a shared A on a row mesh,
    # means K6b takes it dense.
    A_sparsity: Optional[IPMSparsity] = None
    # K5's A as values (MoE nodes, lanes with an A each, one shared A): each
    # lane's base values on A_sparsity (L, nnz; one row for a shared A),
    # gathered once per sweep, and the
    # places in that vector of the 2M expert-busy entries a MoE node writes
    # its k's values to (2, M; rows 4M+i and 5M+i of column 2M+i).
    A_values: Optional[torch.Tensor] = None
    gky_pos: Optional[torch.Tensor] = None
    # A's row blocks on a row mesh (K6b), kept on the static entry
    # (packed.StaticEntry.mesh_blocks): for a per-element A (K6b's
    # per-element entry) A_sparsity split into the mesh's row blocks
    # (ops/meshlp.py::row_blocks), each block's structure and the places of
    # its nonzeros in A_values' rows, a round taking each shard's values
    # with one index_select; for one shared A its dense blocks and their
    # transposes in the iterate dtype (ops/meshlp.py::dense_blocks). None
    # off the mesh.
    A_shards: Optional[Union[RowBlocks, DenseBlocks]] = None
    # K1's values on A_sparsity of a shared (m, nf) A (packed.StaticEntry),
    # and whether A_sparsity was checked against A when it was built (the
    # search's K1 calls then skip the per-call check).
    A_k1_values: Optional[torch.Tensor] = None
    A_checked: bool = False


class EpilogueOut(NamedTuple):
    """Per-row result of the round epilogue (K3)."""

    bound: torch.Tensor  # (B,) float64 folded bound
    survive: torch.Tensor  # (B,) bool
    lo_a: torch.Tensor  # (B, nf) child A box (hi at j* -> floor)
    hi_a: torch.Tensor
    lo_b: torch.Tensor  # (B, nf) child B box (lo at j* -> floor + 1)
    hi_b: torch.Tensor
    v_new: torch.Tensor  # (B, nf) warm carry for both children
    y_new: torch.Tensor  # (B, m)
    z_new: torch.Tensor  # (B, nf)
    f_new: torch.Tensor  # (B, nf)
    warm_new: torch.Tensor  # (B,) bool


def select_lanes(keep_old: torch.Tensor, old: SearchState, new: SearchState) -> SearchState:
    """``old`` in the lanes where ``keep_old`` (L,) holds, ``new`` elsewhere:
    a frozen lane's state carried through a round unchanged."""
    def pick(a, b):
        return torch.where(keep_old.view(-1, *([1] * (a.dim() - 1))), a, b)
    return SearchState(*[pick(a, b) for a, b in zip(old, new)])


def root_state(
    lo_k: torch.Tensor, hi_k: torch.Tensor, M: int, cap: int, m: int,
    root_warm=None,
) -> SearchState:
    """Root frontier: one node per k. ``root_warm`` = (ok (n_k,), v, y, z, f)
    seeds the roots' IPM iterates from a previous solve's root round. Every
    argument carries the leading lane axis: ``lo_k``/``hi_k`` (L, n_k, nf),
    ``ok`` (L, n_k)."""
    L, n_k, nf = lo_k.shape
    dev = lo_k.device

    def zeros(*shape, dtype=DTYPE):
        return torch.zeros((L, *shape), dtype=dtype, device=dev)

    def full(shape, value):
        return torch.full((L, *shape), value, dtype=BDTYPE, device=dev)

    node_v, node_y, node_z, node_f = zeros(cap, nf), zeros(cap, m), zeros(cap, nf), zeros(cap, nf)
    node_warm = zeros(cap, dtype=torch.bool)
    if root_warm is not None:
        ok_w, v_w, y_w, z_w, f_w = root_warm
        node_v[:, :n_k] = v_w.to(DTYPE)
        node_y[:, :n_k] = y_w.to(DTYPE)
        node_z[:, :n_k] = z_w.to(DTYPE)
        node_f[:, :n_k] = f_w.to(DTYPE)
        node_warm[:, :n_k] = ok_w.to(torch.bool)
    node_lo = zeros(cap, nf)
    node_lo[:, :n_k] = lo_k.to(DTYPE)
    node_hi = zeros(cap, nf)
    node_hi[:, :n_k] = hi_k.to(DTYPE)
    node_kidx = zeros(cap, dtype=torch.int32)
    node_kidx[:, :n_k] = torch.arange(n_k, dtype=torch.int32, device=dev)
    active = zeros(cap, dtype=torch.bool)
    active[:, :n_k] = True
    inf = float("inf")
    return SearchState(
        node_lo=node_lo,
        node_hi=node_hi,
        node_kidx=node_kidx,
        node_bound=full((cap,), -inf),
        active=active,
        incumbent=full((), inf),
        inc_w=zeros(M, dtype=BDTYPE),
        inc_n=zeros(M, dtype=BDTYPE),
        inc_y=zeros(M, dtype=BDTYPE),
        inc_kidx=zeros(dtype=torch.int32),
        dropped_bound=full((), inf),
        per_k_best=full((n_k,), inf),
        per_k_w=zeros(n_k, M, dtype=BDTYPE),
        per_k_n=zeros(n_k, M, dtype=BDTYPE),
        per_k_y=zeros(n_k, M, dtype=BDTYPE),
        per_k_dropped=full((n_k,), inf),
        node_v=node_v,
        node_y=node_y,
        node_z=node_z,
        node_f=node_f,
        node_warm=node_warm,
        stat_ipm_iters=zeros(dtype=BDTYPE),
        stat_rounds=zeros(dtype=BDTYPE),
    )


def best_bound(state: SearchState) -> torch.Tensor:
    """The proven lower bound of each lane, (L,)."""
    inf = torch.full_like(state.node_bound, float("inf"))
    live = torch.where(state.active, state.node_bound, inf).amin(-1)
    return torch.minimum(live, state.dropped_bound)


def certified(state: SearchState, mip_gap: float) -> torch.Tensor:
    inc = state.incumbent
    return torch.isfinite(inc) & (inc - best_bound(state) <= mip_gap * inc.abs())


def per_k_bound(state: SearchState) -> torch.Tensor:
    """(n_k,) proven lower bound of each k (per lane): the least bound of its
    live nodes and its own overflow floor."""
    live = torch.where(state.active, state.node_bound, float("inf"))
    bound = torch.full_like(state.per_k_best, float("inf"))
    bound = bound.scatter_reduce(-1, state.node_kidx.long(), live, "amin")
    return torch.minimum(bound, state.per_k_dropped)


def certified_per_k(state: SearchState, mip_gap: float) -> torch.Tensor:
    """True when every k is settled (per lane): its own gap closed, or its
    subtree exhausted (bound +inf; a -inf bound is an unexplored root)."""
    bound_k = per_k_bound(state)
    inc_k = state.per_k_best
    done = torch.isfinite(inc_k) & (inc_k - bound_k <= mip_gap * inc_k.abs())
    return (done | torch.isposinf(bound_k)).all(-1)


class PerKIncumbent(NamedTuple):
    """Result of K3's per-k incumbent entry (per lane)."""

    per_k_best: torch.Tensor  # (n_k,) float64
    per_k_w: torch.Tensor  # (n_k, M) float64
    per_k_n: torch.Tensor
    per_k_y: torch.Tensor
    threshold: torch.Tensor  # (cap,) float64 prune threshold of every row


def per_k_incumbent(
    obj_full: torch.Tensor,
    kidx_p: torch.Tensor,
    w_int: torch.Tensor,
    n_int: torch.Tensor,
    y_int: Optional[torch.Tensor],
    state: SearchState,
    mip_gap: float,
) -> PerKIncumbent:
    """K3's per-k incumbent entry: each k's best row of this round
    (``obj_full`` over the (B,) rows of k ``kidx_p``, first index on ties),
    the per-k incumbents and assignments it improves (``y_int`` None in dense
    mode: a zero row), and the prune threshold of every frontier row from its
    own k's incumbent. Every argument carries the leading lane axis (L, …):
    one launch, one block per lane. The CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    if kernels.on_cuda(obj_full, kidx_p, w_int, n_int, state.per_k_best):
        fn = _per_k_incumbent_kernel
    else:
        fn = per_k_incumbent_reference
    return fn(obj_full, kidx_p, w_int, n_int, y_int, state, mip_gap)


def per_k_incumbent_reference(
    obj_full, kidx_p, w_int, n_int, y_int, state: SearchState, mip_gap: float
) -> PerKIncumbent:
    """Plain PyTorch version of K3's per-k incumbent entry."""
    inf = float("inf")
    L, n_k = state.per_k_best.shape
    kidx = kidx_p.long()
    round_best = torch.full((L, n_k), inf, dtype=BDTYPE, device=obj_full.device)
    round_best = round_best.scatter_reduce(1, kidx, obj_full, "amin")
    improved = (round_best < state.per_k_best)[..., None]
    k_mask = kidx[:, :, None] == torch.arange(n_k, device=kidx.device)
    r_star = torch.where(k_mask, obj_full[:, :, None], inf).argmin(1)  # (L, n_k)
    if y_int is None:
        y_int = torch.zeros_like(w_int)
    lanes = torch.arange(L, device=kidx.device)[:, None]
    best = torch.minimum(state.per_k_best, round_best)
    threshold_k = torch.where(torch.isfinite(best), best - mip_gap * best.abs(), inf)
    return PerKIncumbent(
        per_k_best=best,
        per_k_w=torch.where(improved, w_int[lanes, r_star], state.per_k_w),
        per_k_n=torch.where(improved, n_int[lanes, r_star], state.per_k_n),
        per_k_y=torch.where(improved, y_int[lanes, r_star], state.per_k_y),
        threshold=threshold_k.gather(1, state.node_kidx.long()),
    )


def _per_k_incumbent_kernel(
    obj_full, kidx_p, w_int, n_int, y_int, state: SearchState, mip_gap: float
) -> PerKIncumbent:
    from ..kernels.build import library

    L, B, M = w_int.shape
    n_k = state.per_k_best.shape[1]
    cap = state.node_kidx.shape[1]
    f64 = [obj_full, w_int, n_int, state.per_k_best, state.per_k_w, state.per_k_n,
           state.per_k_y] + ([] if y_int is None else [y_int])
    if any(t.dtype != BDTYPE for t in f64):
        raise TypeError("per-k incumbent kernel takes float64 objectives and assignments")
    dev = obj_full.device
    # Held until the launch (a temporary freed inside the argument list could
    # hand its memory to the next one).
    rows = [obj_full.contiguous(), kidx_p.to(torch.int32).contiguous(),
            w_int.contiguous(), n_int.contiguous()]
    y_c = None if y_int is None else y_int.contiguous()
    old = [t.contiguous() for t in (state.per_k_best, state.per_k_w, state.per_k_n,
                                    state.per_k_y)]
    node_kidx = state.node_kidx.to(torch.int32).contiguous()
    out = PerKIncumbent(
        per_k_best=torch.empty((L, n_k), dtype=BDTYPE, device=dev),
        per_k_w=torch.empty((L, n_k, M), dtype=BDTYPE, device=dev),
        per_k_n=torch.empty((L, n_k, M), dtype=BDTYPE, device=dev),
        per_k_y=torch.empty((L, n_k, M), dtype=BDTYPE, device=dev),
        threshold=torch.empty((L, cap), dtype=BDTYPE, device=dev),
    )
    P = kernels.ptr
    err = library("bnb_epilogue").dtk_bnb_per_k_incumbent(
        P(rows[0]), P(rows[1]), B, P(rows[2]), P(rows[3]), kernels.opt_ptr(y_c), M,
        *[P(t) for t in old], n_k, P(node_kidx), cap, float(mip_gap),
        *[P(t) for t in out], L, PER_K_THREADS, kernels.stream_handle(dev),
    )
    kernels.check(err, "bnb_per_k")
    kernels.LAUNCHES["bnb_per_k_lanes" if L > 1 else "bnb_per_k"] += 1
    return out


def per_k_fair_rank(
    order: torch.Tensor,
    child_kidx: torch.Tensor,
    child_active: torch.Tensor,
    child_bound: torch.Tensor,
    cap: int,
    per_k_dropped: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's per-k rank entry, on the first (best-bound-first) stable order
    of the child rows: ``(fair_key, per_k_dropped)``. ``fair_key`` (int64,
    one per sorted position p) is ``rank * (total + 1) + p`` where rank is the
    row's place among its k's active rows (``total`` for an inactive row),
    so that sorting it shares the capacity round-robin between the k's;
    ``per_k_dropped`` folds in, per k, the least bound of the active rows
    that order puts past ``cap``. Every argument carries the leading lane
    axis (``order`` indexes each lane's own rows): one launch, one block per
    lane. The CUDA kernel on CUDA tensors, the plain version on CPU
    tensors."""
    if kernels.on_cuda(order, child_kidx, child_active, child_bound, per_k_dropped):
        fn = _per_k_fair_rank_kernel
    else:
        fn = per_k_fair_rank_reference
    return fn(order, child_kidx, child_active, child_bound, cap, per_k_dropped)


def per_k_fair_rank_reference(
    order, child_kidx, child_active, child_bound, cap: int, per_k_dropped
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3's per-k rank entry."""
    L, n_k = per_k_dropped.shape
    total = order.shape[1]
    dev = order.device
    kidx_sorted = child_kidx.gather(1, order).long()
    active_sorted = child_active.gather(1, order)
    onehot = (kidx_sorted[..., None] == torch.arange(n_k, device=dev)) & \
        active_sorted[..., None]
    counts = torch.cumsum(onehot.to(torch.int32), 1)
    rank = counts.gather(2, kidx_sorted.clamp(0, n_k - 1)[..., None])[..., 0].long() - 1
    pos = torch.arange(total, dtype=torch.int64, device=dev)
    fair_key = torch.where(active_sorted, rank, total) * (total + 1) + pos
    spill = order.gather(1, torch.argsort(fair_key, dim=1, stable=True))[:, cap:]
    spill_live = torch.where(child_active.gather(1, spill), child_bound.gather(1, spill),
                             float("inf"))
    floor = torch.full((L, n_k), float("inf"), dtype=BDTYPE, device=dev)
    floor = floor.scatter_reduce(1, child_kidx.gather(1, spill).long(), spill_live, "amin")
    return fair_key, torch.minimum(per_k_dropped, floor)


def _per_k_fair_rank_kernel(order, child_kidx, child_active, child_bound, cap: int,
                            per_k_dropped):
    from ..kernels.build import library

    if child_bound.dtype != BDTYPE or per_k_dropped.dtype != BDTYPE:
        raise TypeError("per-k rank kernel takes float64 bounds")
    L, n_k = per_k_dropped.shape
    total = order.shape[1]
    dev = order.device
    fair_key = torch.empty((L, total), dtype=torch.int64, device=dev)
    dropped = torch.empty((L, n_k), dtype=BDTYPE, device=dev)
    P = kernels.ptr
    ins = [order.to(torch.int64).contiguous(), child_kidx.to(torch.int32).contiguous(),
           child_active.to(torch.uint8).contiguous(), child_bound.contiguous(),
           per_k_dropped.contiguous()]
    err = library("bnb_epilogue").dtk_bnb_per_k_rank(
        P(ins[0]), total, P(ins[1]), P(ins[2]), P(ins[3]), n_k, cap, P(ins[4]),
        P(fair_key), P(dropped), L, PER_K_RANK_THREADS, kernels.stream_handle(dev),
    )
    kernels.check(err, "bnb_per_k")
    kernels.LAUNCHES["bnb_per_k_lanes" if L > 1 else "bnb_per_k"] += 1
    return fair_key, dropped


def bnb_epilogue(
    lo: torch.Tensor,
    hi: torch.Tensor,
    res: IPMResult,
    parent_bound: torch.Tensor,
    active: torch.Tensor,
    obj_full: torch.Tensor,
    threshold: torch.Tensor,
    int_mask: torch.Tensor,
    obj_const: torch.Tensor,
    node_v: torch.Tensor,
    node_y: torch.Tensor,
    node_z: torch.Tensor,
    node_f: torch.Tensor,
    node_warm: torch.Tensor,
    inst: torch.Tensor,
) -> EpilogueOut:
    """Per-row epilogue of one round (see :class:`EpilogueOut`): the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors. ``threshold``
    is the (B,) pruning threshold of each row. ``int_mask`` (R, nf) and
    ``obj_const`` (R,) float64 are R sweeps'; ``inst`` (B,) names each
    row's sweep."""
    if kernels.on_cuda(lo, hi, res.v, parent_bound, obj_full, threshold, node_v):
        fn = _epilogue_kernel
    else:
        fn = bnb_epilogue_reference
    return fn(lo, hi, res, parent_bound, active, obj_full, threshold, int_mask,
              obj_const, node_v, node_y, node_z, node_f, node_warm, inst)


def bnb_epilogue_reference(
    lo, hi, res, parent_bound, active, obj_full, threshold, int_mask,
    obj_const, node_v, node_y, node_z, node_f, node_warm, inst,
) -> EpilogueOut:
    """Plain PyTorch version of the epilogue kernel."""
    inf = float("inf")
    B = lo.shape[0]
    rows = torch.arange(B, device=lo.device)
    im = int_mask[inst.long()]
    obj_const = obj_const[inst.long()]
    # A diverged LP reports -inf; fold with the parent bound. Rows that were
    # not processed get +inf.
    bound_raw = res.bound + obj_const
    bound = torch.where(torch.isfinite(bound_raw), bound_raw, -inf)
    bound = torch.where(active, torch.maximum(bound, parent_bound), inf)
    survive = active & (bound < threshold)

    # Reduced-cost box tightening: a unit move of an integer variable off
    # its bound-active side costs |red_j| in the Lagrangian bound.
    budget = threshold - bound_raw
    budget = torch.where(torch.isfinite(budget) & (budget >= 0), budget, inf)[:, None]
    lo64, hi64 = lo.to(BDTYPE), hi.to(BDTYPE)
    red = res.reduced
    tight_hi = torch.where(
        im & (red > 1e-12),
        torch.floor(lo64 + budget / torch.clamp(red, min=1e-12) + 1e-9),
        hi64,
    )
    tight_lo = torch.where(
        im & (red < -1e-12),
        torch.ceil(hi64 - budget / torch.clamp(-red, min=1e-12) - 1e-9),
        lo64,
    )
    hi_p = torch.minimum(hi, tight_hi.to(DTYPE))
    lo_p = torch.maximum(lo, tight_lo.to(DTYPE))
    survive = survive & (lo_p <= hi_p).all(1)

    width = torch.where(im, hi_p - lo_p, 0.0)
    fully_fixed = width.amax(1) < 0.5
    achieved = obj_full <= bound + 1e-6 * torch.clamp(bound.abs(), min=1.0)
    survive = survive & ~(fully_fixed | achieved)

    # Branch variable: most fractional branchable column, else the widest.
    frac = (res.v - torch.round(res.v)).abs()
    frac_m = torch.where(im & (width > 0.5), frac, -1.0)
    j_frac = frac_m.argmax(1)
    max_frac = frac_m[rows, j_frac]
    j_wide = width.argmax(1)
    has_frac = max_frac > FRAC_TOL
    j_star = torch.where(has_frac, j_frac, j_wide)
    lo_j = lo_p[rows, j_star]
    hi_j = hi_p[rows, j_star]
    vj = res.v[rows, j_star]
    split = torch.where(has_frac, vj, 0.5 * (lo_j + hi_j))
    dn = torch.minimum(
        torch.maximum(torch.floor(split), lo_j), torch.maximum(hi_j - 1.0, lo_j)
    )
    hi_a = hi_p.clone()
    hi_a[rows, j_star] = dn
    lo_b = lo_p.clone()
    lo_b[rows, j_star] = dn + 1.0

    solved = active[:, None]
    return EpilogueOut(
        bound=bound,
        survive=survive,
        lo_a=lo_p,
        hi_a=hi_a,
        lo_b=lo_b,
        hi_b=hi_p,
        v_new=torch.where(solved, res.v.to(DTYPE), node_v),
        y_new=torch.where(solved, res.y_dual.to(DTYPE), node_y),
        z_new=torch.where(solved, res.z_dual.to(DTYPE), node_z),
        f_new=torch.where(solved, res.f_dual.to(DTYPE), node_f),
        warm_new=active | node_warm,
    )


def _epilogue_kernel(
    lo, hi, res, parent_bound, active, obj_full, threshold, int_mask,
    obj_const, node_v, node_y, node_z, node_f, node_warm, inst,
) -> EpilogueOut:
    from ..kernels.build import library

    B, nf = lo.shape
    m = res.y_dual.shape[1]
    f32 = [lo, hi, res.v, res.y_dual, res.z_dual, res.f_dual,
           node_v, node_y, node_z, node_f]
    if any(t.dtype != DTYPE for t in f32):
        raise TypeError("epilogue kernel takes float32 boxes, iterates and duals")
    f64 = [res.reduced, res.bound, parent_bound, obj_full, threshold, obj_const]
    if any(t.dtype != BDTYPE for t in f64):
        raise TypeError("epilogue kernel takes float64 bounds and reduced costs")
    c = lambda t: t.contiguous()  # noqa: E731
    u8 = lambda t: t.to(torch.uint8).contiguous()  # noqa: E731
    dev = lo.device
    out = EpilogueOut(
        bound=torch.empty(B, dtype=BDTYPE, device=dev),
        survive=torch.empty(B, dtype=torch.bool, device=dev),
        lo_a=torch.empty((B, nf), dtype=DTYPE, device=dev),
        hi_a=torch.empty((B, nf), dtype=DTYPE, device=dev),
        lo_b=torch.empty((B, nf), dtype=DTYPE, device=dev),
        hi_b=torch.empty((B, nf), dtype=DTYPE, device=dev),
        v_new=torch.empty((B, nf), dtype=DTYPE, device=dev),
        y_new=torch.empty((B, m), dtype=DTYPE, device=dev),
        z_new=torch.empty((B, nf), dtype=DTYPE, device=dev),
        f_new=torch.empty((B, nf), dtype=DTYPE, device=dev),
        warm_new=torch.empty(B, dtype=torch.bool, device=dev),
    )
    if B == 0:
        return out
    inst = inst.to(torch.int32).contiguous()
    if inst.shape != (B,) or int_mask.dim() != 2 or obj_const.shape != int_mask.shape[:1]:
        raise ValueError("epilogue kernel takes inst (B,), int_mask (R, nf), obj_const (R,)")
    ins = [c(lo), c(hi), c(res.v), c(res.reduced), c(res.y_dual), c(res.z_dual),
           c(res.f_dual), c(res.bound), c(parent_bound), u8(active), c(obj_full),
           c(threshold), u8(int_mask), c(obj_const)]
    warm_ins = [c(node_v), c(node_y), c(node_z), c(node_f), u8(node_warm)]
    P = kernels.ptr
    err = library("bnb_epilogue").dtk_bnb_epilogue(
        *[P(t) for t in ins], P(inst), *[P(t) for t in warm_ins],
        B, nf, m, *[P(t) for t in out], EPILOGUE_THREADS,
        kernels.stream_handle(dev),
    )
    kernels.check(err, "bnb_epilogue")
    kernels.LAUNCHES["bnb_epilogue_lanes" if int_mask.shape[0] > 1 else "bnb_epilogue"] += 1
    return out


def cast_lp_result(res: IPMResult, tgt: torch.dtype) -> IPMResult:
    """Cast an LP result's iteration-dtype fields back to the search dtype,
    as the reference does after a ``pdhg_dtype='f64'`` solve: ``bound``
    (already the float64 certificate) and ``converged`` pass through, every
    other field is rounded to ``tgt``. ``reduced`` is rounded too, then held
    in float64 for the epilogue kernel, so reduced-cost tightening sees the
    reference's values."""
    if res.v.dtype == tgt:
        return res
    cast = {
        f: getattr(res, f).to(tgt)
        for f in ("v", "obj", "rp_norm", "rd_norm", "mu", "y_dual", "z_dual",
                  "f_dual", "iters_run")
    }
    cast["reduced"] = res.reduced.to(tgt).to(BDTYPE)
    if res.trace_buf is not None:
        cast["trace_buf"] = res.trace_buf.to(tgt)
    return res._replace(**cast)


def node_A(data: SweepData, kidx: torch.Tensor, M: int, lane: torch.Tensor) -> torch.Tensor:
    """The constraint matrix of each node of (B,) rows of k ``kidx`` in lane
    ``lane``: the shared (m, nf) A in dense mode (one lane's own A, gathered
    per row, for lanes with an A each); in MoE mode a contiguous (B, m, nf)
    copy of the base per node with its k's 2M expert-busy entries scattered
    in (K1's per-element route)."""
    A = data.A
    if A.dim() == 2 or A.shape[0] == 1:
        A = A if A.dim() == 2 else A[0]
        base = A.expand(kidx.shape[0], *A.shape)
    else:
        base = A[lane]
    g_p = None if data.gky is None else data.gky[lane, kidx]  # (B, 2, M)
    if g_p is None:
        return A if A.dim() == 2 else base
    A_p = base.clone()
    ar = torch.arange(M, device=A.device)
    A_p[:, 4 * M + ar, 2 * M + ar] = g_p[:, 0, :]
    A_p[:, 5 * M + ar, 2 * M + ar] = g_p[:, 1, :]
    return A_p


def node_values(data: SweepData, kidx: torch.Tensor, lane: torch.Tensor) -> torch.Tensor:
    """K5's per-element A of (B,) rows of k ``kidx`` in lane ``lane``: each
    row's lane's base values on ``data.A_sparsity`` with, in MoE mode, its
    k's 2M expert-busy entries written at their places (the values form of
    :func:`node_A`), (B, nnz). Scenario lanes share one A: one value
    set; with no expert-busy entries to write, its rows are one row with a
    batch stride of 0 (the kernel's shared A)."""
    if data.gky is None and data.A_values.shape[0] == 1:
        # One A for every row: its one value set with a batch stride of 0.
        return data.A_values.as_strided((lane.shape[0], data.A_values.shape[1]), (0, 1))
    vals = data.A_values[lane if data.A_values.shape[0] > 1 else torch.zeros_like(lane)]
    if data.gky is not None:
        g_p = data.gky[lane, kidx]  # (B, 2, M)
        rows = torch.arange(vals.shape[0], device=vals.device)[:, None]
        vals[rows, data.gky_pos[0]] = g_p[:, 0, :]
        vals[rows, data.gky_pos[1]] = g_p[:, 1, :]
    return vals


def sweep_values(A: torch.Tensor, sparsity: IPMSparsity, M: int, moe: bool):
    """(A_values, gky_pos) of :class:`SweepData` for K5's per-element
    entry: each lane's A (L, m, nf), or the one (m, nf) A, gathered on
    ``sparsity`` once; in MoE mode the places of the expert-busy entries
    (which ``sparsity`` holds, see :func:`node_sparsity`)."""
    m, n = sparsity.m, sparsity.n
    A3 = A if A.dim() == 3 else A[None]
    values = A3.reshape(A3.shape[0], m * n)[:, sparsity.src]
    gky_pos = None
    if moe:
        place = torch.full((m * n,), -1, dtype=torch.int64, device=A.device)
        place[sparsity.src] = torch.arange(sparsity.nnz, device=A.device)
        ar = torch.arange(M, device=A.device)
        gky_pos = torch.stack([place[(4 * M + ar) * n + 2 * M + ar],
                               place[(5 * M + ar) * n + 2 * M + ar]])
    return values, gky_pos


def node_sparsity(A: torch.Tensor, M: int, moe: bool) -> IPMSparsity:
    """The structure of every node's A (K1's, and K5's per-element
    entry's): the base's nonzeros (the union over the lanes for a (L, m, nf)
    stack), and in MoE mode the 2M expert-busy entries ``node_A`` scatters
    in."""
    pattern = A != 0
    if pattern.dim() == 3:
        pattern = pattern.any(0)
    if moe:
        ar = torch.arange(M, device=A.device)
        pattern[4 * M + ar, 2 * M + ar] = True
        pattern[5 * M + ar, 2 * M + ar] = True
    return ipm_sparsity(pattern)


def _lanes_of(L: int, per_lane: int, device) -> torch.Tensor:
    """(L * per_lane,) lane index of each flattened row."""
    return torch.arange(L, device=device).repeat_interleave(per_lane)


def seed_root_bounds(
    state: SearchState,
    data: SweepData,
    p32,
    p64,
    decomp_steps: int,
    init_duals=None,
    margin=None,
):
    """Root Lagrangian decomposition bounds (K7, every lane in one ascent)
    into the roots' node bounds, and, on cold solves (``decomp_steps >
    0``), each k's Lagrangian-primal cell repaired to a feasible placement
    (K2's hint mode, ``e_max + 4`` repair steps) as incumbent candidates.
    Lane data and state; ``p32``/``p64`` are the lanes' ``DecompBatch``es
    and ``init_duals`` (lam (L, n_k), mu, tau (L, n_k, M)). Returns
    ``(state, duals, raw_bounds, m_y)``; the raw bounds exclude
    ``obj_const``. A warm tick (``decomp_steps == 0``) only re-evaluates the
    bound at ``init_duals``: its incumbent is the previous optimum.

    ``margin`` (L, n_k), the margin fast path: bounds already re-derived on
    the host from a previous full evaluation replace the evaluation
    entirely; the stored duals pass through and ``m_y`` is None."""
    L, n_k = data.ks.shape
    M = state.inc_w.shape[-1]
    nf = state.node_lo.shape[-1]
    node_bound = state.node_bound.clone()
    if margin is not None:
        node_bound[:, :n_k] = margin + data.obj_const[:, None]
        return state._replace(node_bound=node_bound), init_duals, margin, None
    raw, w_star, n_star, y_star, duals, m_y = decomp_bound_roots(
        p32, p64, data.rd, decomp_steps, init_duals
    )
    node_bound[:, :n_k] = raw + data.obj_const[:, None]
    state = state._replace(node_bound=node_bound)
    if decomp_steps == 0:
        return state, duals, raw, m_y

    v_hint = torch.zeros((L, n_k, nf), dtype=BDTYPE, device=raw.device)
    v_hint[..., :M] = w_star
    v_hint[..., M : 2 * M] = n_star
    v_hint[..., 2 * M : 3 * M] = y_star
    lag_obj, lag_w, lag_n, lag_y = (
        t.reshape(L, n_k, *t.shape[1:]) for t in round_to_incumbent(
            v_hint.reshape(L * n_k, nf), data.Ws.reshape(-1), data.ks.reshape(-1), data.rd,
            data.rd_packed, moe=True, y_steps=p64.e_max + 4,
            inst=_lanes_of(L, n_k, raw.device),
        )
    )
    lag_obj = lag_obj + data.obj_const[:, None]
    lanes = torch.arange(L, device=raw.device)
    jbest = lag_obj.argmin(1)
    best = lag_obj[lanes, jbest]
    better = best < state.incumbent
    b1 = better[:, None]
    clean = torch.where(torch.isfinite(lag_obj), lag_obj, float("inf"))
    seeded_k = (clean < state.per_k_best)[..., None]
    state = state._replace(
        incumbent=torch.where(better, best, state.incumbent),
        inc_w=torch.where(b1, lag_w[lanes, jbest], state.inc_w),
        inc_n=torch.where(b1, lag_n[lanes, jbest], state.inc_n),
        inc_y=torch.where(b1, lag_y[lanes, jbest], state.inc_y),
        inc_kidx=torch.where(better, jbest.to(torch.int32), state.inc_kidx),
        per_k_best=torch.minimum(state.per_k_best, clean),
        per_k_w=torch.where(seeded_k, lag_w, state.per_k_w),
        per_k_n=torch.where(seeded_k, lag_n, state.per_k_n),
        per_k_y=torch.where(seeded_k, lag_y, state.per_k_y),
    )
    return state, duals, raw, m_y


def seed_warm(state: SearchState, data: SweepData, warm, moe: bool, moves: int):
    """Re-price each lane's previous assignment exactly under THIS sweep's
    coefficients and seed the incumbent with it (an infeasible hint prices
    to +inf and leaves the lane cold). ``warm`` = (k index (L,), w, n, y
    (L, M)) on the device; one K2 launch over the L hints (MoE: its short
    warm move search, ``moves`` steps)."""
    kidx_in, w, n, y = warm
    L, n_k = data.ks.shape
    M = state.inc_w.shape[-1]
    nf = state.node_lo.shape[-1]
    dev = data.ks.device
    lanes = torch.arange(L, device=dev)
    kidx = kidx_in.long().clamp(0, n_k - 1)
    v = torch.zeros((L, nf), dtype=BDTYPE, device=dev)
    v[:, :M] = w
    v[:, M : 2 * M] = n
    if moe:
        v[:, 2 * M : 3 * M] = y
    out = round_to_incumbent(
        v, data.Ws[lanes, kidx], data.ks[lanes, kidx], data.rd, data.rd_packed,
        moe=moe, moves=moves, inst=lanes,
    )
    obj, w_rep, n_rep = out[:3]
    y_rep = out[3] if moe else state.inc_y
    warm_obj = obj + data.obj_const
    seeded = torch.isfinite(warm_obj) & (warm_obj < state.incumbent)
    clean = torch.where(torch.isfinite(warm_obj), warm_obj, float("inf"))
    seeded_k = (clean < state.per_k_best[lanes, kidx])[:, None]
    per_k_best = state.per_k_best.clone()
    per_k_best[lanes, kidx] = torch.minimum(per_k_best[lanes, kidx], clean)
    per_k = {}
    for name, rep in (("per_k_w", w_rep), ("per_k_n", n_rep), ("per_k_y", y_rep)):
        t = getattr(state, name).clone()
        t[lanes, kidx] = torch.where(seeded_k, rep, t[lanes, kidx])
        per_k[name] = t
    s1 = seeded[:, None]
    return state._replace(
        incumbent=torch.where(seeded, warm_obj, state.incumbent),
        inc_w=torch.where(s1, w_rep, state.inc_w),
        inc_n=torch.where(s1, n_rep, state.inc_n),
        inc_y=torch.where(s1, y_rep, state.inc_y),
        inc_kidx=torch.where(seeded, kidx.to(torch.int32), state.inc_kidx),
        per_k_best=per_k_best,
        **per_k,
    )


class RoundInputs(NamedTuple):
    """A round's LP inputs, L * B rows lane-major: each row's k index and
    lane, b and c (its lane's, at its k), box, warm iterate and skip."""

    kidx: torch.Tensor  # (R,) int64
    lane: torch.Tensor  # (R,) int64
    b: torch.Tensor  # (R, m)
    c: torch.Tensor  # (R, nf)
    lo: torch.Tensor  # (R, nf)
    hi: torch.Tensor
    warm: IPMWarmState
    skip: torch.Tensor  # (R,) bool: an inactive row or a frozen lane's


def round_inputs(data: SweepData, state: SearchState, B: int,
                 frozen: Optional[torch.Tensor] = None) -> RoundInputs:
    """The LP inputs of a round over the first ``B`` rows of every lane: the
    round head's plain version (``bnb_loop_kernel.cu``'s ``bnb_head_kernel``
    writes the same rows on the card). ``frozen`` (L,) bool marks settled
    lanes, whose rows skip."""
    L = state.node_lo.shape[0]
    row_lane = _lanes_of(L, B, state.node_lo.device)

    def flat(t):
        return t.reshape(L * B, *t.shape[2:])

    active_p = state.active[:, :B]
    if frozen is not None:
        active_p = active_p & ~frozen[:, None]
    kidx_r = flat(state.node_kidx[:, :B].long())
    warm = IPMWarmState(
        v=flat(state.node_v[:, :B]),
        y=flat(state.node_y[:, :B]),
        z=flat(state.node_z[:, :B]),
        f=flat(state.node_f[:, :B]),
        ok=flat(state.node_warm[:, :B]),
    )
    b_r, c_r = data.b_k[row_lane, kidx_r], data.c_k[row_lane, kidx_r]
    return RoundInputs(kidx_r, row_lane, b_r, c_r, flat(state.node_lo[:, :B]),
                       flat(state.node_hi[:, :B]), warm, ~flat(active_p))


def bnb_round(
    data: SweepData,
    state: SearchState,
    mip_gap: float,
    ipm_iters: int = IPM_ITERS,
    beam: Optional[int] = None,
    ipm_chunk: Optional[int] = None,
    lp_backend: str = "ipm",
    pdhg_restart_tol: Optional[float] = None,
    pdhg_dtype: Optional[str] = None,
    per_k: bool = False,
    frozen: Optional[torch.Tensor] = None,
    lp_trace: bool = False,
    row_mesh: Optional[Mesh] = None,
    node_mesh: Optional["NodeMesh"] = None,
) -> Tuple[SearchState, IPMResult]:
    """One batched branch-and-bound round over the frontier prefix of
    ``beam`` rows of every lane (rows past it pass through with their parent
    bound). ``ipm_iters`` is the LP budget of whichever engine
    ``lp_backend`` names; ``ipm_chunk`` (the IPM's cold-root full-length
    chunk) is never passed to the PDHG, whose convergence point inside its
    budget is unknown even cold. ``per_k`` prunes every node against its own
    k's incumbent and keeps the per-k assignments, a k-fair compaction and
    the per-k overflow floors (the round tail's per-k mode). ``frozen`` (L,) bool
    marks settled lanes: their rows go to the LP as skipped and their state
    comes back unchanged. ``lp_trace`` records the LP engine's convergence
    trace (the result's ``trace_buf``). ``row_mesh`` (more than one shard)
    row-partitions every PDHG relaxation over its shards (K6b); ``node_mesh``
    (K10) splits the beam rows over its shards, each shard's rows going
    through the LP engine and the rounding on that shard's device, then
    gathered onto shard 0 for the incumbent reduction, the epilogue and the
    compaction (the beam a multiple of the mesh size). After the LP call a
    round is one :func:`round_tail` (one launch on a card; MoE rows rounded
    by K2's MoE mode before it). Returns the new state and the
    beam rows' raw LP result (L * beam rows, lane-major)."""
    out, res, _ = _bnb_round(data, state, mip_gap, ipm_iters, beam, ipm_chunk, lp_backend,
                             pdhg_restart_tol, pdhg_dtype, per_k, frozen, lp_trace, row_mesh,
                             node_mesh)
    return out, res


def _bnb_round(data, state, mip_gap, ipm_iters, beam, ipm_chunk, lp_backend="ipm",
               pdhg_restart_tol=None, pdhg_dtype=None, per_k=False, frozen=None,
               lp_trace=False, row_mesh=None, node_mesh=None):
    """:func:`bnb_round` and the lanes' go flags on the new state as the
    round tail wrote them ((L,) bool)."""
    cap = state.node_lo.shape[1]
    B = cap if beam is None else min(beam, cap)
    lp_kw = dict(ipm_iters=ipm_iters, ipm_chunk=ipm_chunk, lp_backend=lp_backend,
                 pdhg_restart_tol=pdhg_restart_tol, pdhg_dtype=pdhg_dtype, lp_trace=lp_trace,
                 row_mesh=row_mesh)
    ins = round_inputs(data, state, B, frozen)
    kidx_r, row_lane = ins.kidx, ins.lane
    if node_mesh is not None:
        res, rounded = _node_sharded(node_mesh, ins.lo, ins.hi, kidx_r, row_lane, ins.warm,
                                     ins.skip, lp_kw)
    else:
        res = lp_solve(data, ins.lo, ins.hi, kidx_r, row_lane, ins.warm, ins.skip, **lp_kw,
                       bc=(ins.b, ins.c))
        # The round tail rounds dense rows itself; MoE rows go through K2's
        # MoE mode first.
        rounded = None
        if data.gky is not None:
            rounded = round_rows(data, res, kidx_r, row_lane)
    out, go = round_tail(data, state, res, mip_gap, B, rounded, frozen, per_k)
    return out, res, go


def round_tail(
    data: SweepData,
    state: SearchState,
    res: IPMResult,
    mip_gap: float,
    beam: int,
    rounded: Optional[Tuple[torch.Tensor, ...]] = None,
    frozen: Optional[torch.Tensor] = None,
    per_k: bool = False,
) -> Tuple[SearchState, torch.Tensor]:
    """Everything of a round after its LP call (R8): the rounding of the
    ``beam`` rows of every lane (K2's dense rounding of ``res.v``, or
    ``rounded`` = (obj_lin, w, n[, y]) of the L * beam rows, rounded before:
    K2's MoE mode, or the node-sharded sweep's shards), the incumbent, each
    k's best, the threshold, K3's epilogue, the children's best-bound-first
    compaction, the counters and the frozen lanes' carry, then each lane's
    go flag (any node active and no certificate) on the new state. In
    per-k mode every node prunes against its own k's threshold, the improved
    k's assignments are taken, the compaction is k-fair, each k's spilled
    bounds floor ``per_k_dropped`` and the go flag tests
    :func:`certified_per_k`. Returns ``(new state, go (L,) bool)``, the
    state in fresh memory (the per-k assignments and floors passed through
    outside per-k mode). One launch of ``round_tail_kernel.cu`` on CUDA
    tensors, :func:`round_tail_reference` on CPU tensors."""
    if kernels.on_cuda(state.node_lo, res.v, data.obj_const):
        return _round_tail_kernel(data, state, res, mip_gap, beam, rounded, frozen, per_k)
    return round_tail_reference(data, state, res, mip_gap, beam, rounded, frozen, per_k)


def round_tail_reference(data, state, res, mip_gap, beam, rounded=None, frozen=None,
                         per_k=False):
    """Plain PyTorch version of the round tail: :func:`tail_tensors` (K2, the
    tensor code, K3 and in per-k mode B15's entries, as a round ran them
    before the tail was one kernel) and the go flags of the new state."""
    out = tail_tensors(data, state, res, rounded, mip_gap, beam, per_k, frozen)
    settled = certified_per_k if per_k else certified
    return out, out.active.any(-1) & ~settled(out, mip_gap)


def round_rows(data: SweepData, res: IPMResult, kidx_r, row_lane):
    """The exact integer incumbents (K2; its MoE mode for MoE rows) of a
    round's LP points, every row against its own lane's data."""
    return round_to_incumbent(
        res.v, data.Ws[row_lane, kidx_r], data.ks[row_lane, kidx_r], data.rd,
        data.rd_packed, moe=data.gky is not None, inst=row_lane,
    )


def tail_tensors(data, state, res, rounded, mip_gap, B, per_k, frozen) -> SearchState:
    """A round's tail as tensor code around K2, K3 and, in per-k mode, B15's
    entries: the round tail's plain version (``rounded`` None: the rows
    rounded here)."""
    L, cap = state.node_lo.shape[:2]
    n_k = state.per_k_best.shape[-1]
    inf = float("inf")
    dev = state.node_lo.device
    lanes = torch.arange(L, device=dev)
    lanes_c = lanes[:, None]
    row_lane = _lanes_of(L, B, dev)

    def flat(t):
        return t.reshape(L * B, *t.shape[2:])

    def lanes_b(t):
        return t.reshape(L, B, *t.shape[1:])

    kidx_p = state.node_kidx[:, :B].long()
    active_p = state.active[:, :B]
    if frozen is not None:
        active_p = active_p & ~frozen[:, None]
    if rounded is None:
        rounded = round_rows(data, res, flat(kidx_p), row_lane)
    moe = data.gky is not None
    obj_lin = lanes_b(rounded[0])
    w_int, n_int = lanes_b(rounded[1]), lanes_b(rounded[2])
    y_int = lanes_b(rounded[3]) if moe else None
    obj_full = torch.where(active_p, obj_lin + data.obj_const[:, None], inf)
    best_i = obj_full.argmin(1)
    best_obj = obj_full[lanes, best_i]
    better = best_obj < state.incumbent
    b1 = better[:, None]
    incumbent = torch.where(better, best_obj, state.incumbent)
    inc_w = torch.where(b1, w_int[lanes, best_i], state.inc_w)
    inc_n = torch.where(b1, n_int[lanes, best_i], state.inc_n)
    inc_y = torch.where(b1, y_int[lanes, best_i], state.inc_y) if moe else state.inc_y
    inc_kidx = torch.where(better, kidx_p[lanes, best_i].to(torch.int32), state.inc_kidx)
    per_k_w, per_k_n, per_k_y = state.per_k_w, state.per_k_n, state.per_k_y
    if per_k:
        # Each node prunes against its own k's incumbent (a losing k must
        # still close its own gap): K3's per-k entry updates the per-k
        # incumbents and gives every frontier row its threshold.
        pk = per_k_incumbent(obj_full, kidx_p, w_int, n_int, y_int, state, mip_gap)
        per_k_best = pk.per_k_best
        per_k_w, per_k_n, per_k_y = pk.per_k_w, pk.per_k_n, pk.per_k_y
        threshold, rest_threshold = pk.threshold[:, :B], pk.threshold[:, B:]
    else:
        round_best_k = torch.full((L, n_k), inf, dtype=BDTYPE, device=dev)
        round_best_k = round_best_k.scatter_reduce(1, kidx_p, obj_full, "amin")
        per_k_best = torch.minimum(state.per_k_best, round_best_k)
        # Prune threshold: a node survives only if its bound can still beat
        # the incumbent by more than the relative gap (+inf with no
        # incumbent yet).
        thr = torch.where(
            torch.isfinite(incumbent), incumbent - mip_gap * incumbent.abs(), inf
        )[:, None]
        rest_threshold = thr
        threshold = thr.expand(L, B)
    ep = bnb_epilogue(
        flat(state.node_lo[:, :B]), flat(state.node_hi[:, :B]), res,
        flat(state.node_bound[:, :B]), flat(active_p), flat(obj_full),
        flat(threshold), data.int_mask, data.obj_const,
        flat(state.node_v[:, :B]), flat(state.node_y[:, :B]), flat(state.node_z[:, :B]),
        flat(state.node_f[:, :B]), flat(state.node_warm[:, :B]), inst=row_lane,
    )
    ep = EpilogueOut(*[lanes_b(t) for t in ep])

    # Unprocessed rows pass through, still subject to the new threshold.
    rest_bound = state.node_bound[:, B:]
    rest_active = state.active[:, B:] & (rest_bound < rest_threshold)

    def children(a, b, rest):
        return torch.cat([a, b, rest], 1)

    child_lo = children(ep.lo_a, ep.lo_b, state.node_lo[:, B:])
    child_hi = children(ep.hi_a, ep.hi_b, state.node_hi[:, B:])
    kidx_b = state.node_kidx[:, :B]
    child_kidx = children(kidx_b, kidx_b, state.node_kidx[:, B:])
    child_bound = children(ep.bound, ep.bound, rest_bound)
    child_active = children(ep.survive, ep.survive, rest_active)
    child_v = children(ep.v_new, ep.v_new, state.node_v[:, B:])
    child_y = children(ep.y_new, ep.y_new, state.node_y[:, B:])
    child_z = children(ep.z_new, ep.z_new, state.node_z[:, B:])
    child_f = children(ep.f_new, ep.f_new, state.node_f[:, B:])
    child_warm = children(ep.warm_new, ep.warm_new, state.node_warm[:, B:])

    # Best-bound-first compaction back to the capacity, per lane. Both
    # children of a node share one bound; the stable sort keeps child A
    # ahead of child B.
    sort_key = torch.where(child_active, child_bound, inf)
    order = torch.argsort(sort_key, dim=1, stable=True)
    per_k_dropped = state.per_k_dropped
    if per_k:
        # K-fair compaction: re-rank so each k keeps its best nodes first
        # (one k's deep subtree must not crowd the others out: a spilled
        # node floors its k's certificate for good), and floor each k's
        # certificate at its own spilled nodes.
        fair_key, per_k_dropped = per_k_fair_rank(
            order, child_kidx, child_active, child_bound, cap, state.per_k_dropped
        )
        order = order.gather(1, torch.argsort(fair_key, dim=1, stable=True))
    keep = order[:, :cap]
    spill = order[:, cap:]
    spill_live = torch.where(child_active.gather(1, spill), child_bound.gather(1, spill), inf)
    dropped_bound = torch.minimum(state.dropped_bound, spill_live.amin(1))

    def kept(t):
        return t[lanes_c, keep]

    out = SearchState(
        node_lo=kept(child_lo),
        node_hi=kept(child_hi),
        node_kidx=kept(child_kidx),
        node_bound=kept(child_bound),
        active=kept(child_active),
        incumbent=incumbent,
        inc_w=inc_w,
        inc_n=inc_n,
        inc_y=inc_y,
        inc_kidx=inc_kidx,
        dropped_bound=dropped_bound,
        per_k_best=per_k_best,
        per_k_w=per_k_w,
        per_k_n=per_k_n,
        per_k_y=per_k_y,
        per_k_dropped=per_k_dropped,
        node_v=kept(child_v),
        node_y=kept(child_y),
        node_z=kept(child_z),
        node_f=kept(child_f),
        node_warm=kept(child_warm),
        stat_ipm_iters=state.stat_ipm_iters + lanes_b(res.iters_run).sum(1).to(BDTYPE),
        stat_rounds=state.stat_rounds + 1.0,
    )
    if frozen is not None:
        out = select_lanes(frozen, state, out)
    return out


# An H100 block's dynamic shared memory, which the round tail's one block a
# lane must fit (round_tail_kernel.cu's SMEM_LIMIT).
TAIL_SMEM_LIMIT = 232448
# The round tail indexes a state field's elements in 32 bits.
TAIL_MAX_ELEMENTS = 2 ** 31


class _TailPlan(NamedTuple):
    """How a round tail of one shape signature is launched: the bytes of
    its one allocation, each output's (dtype, shape, strides, element
    offset) in it, the byte offsets the kernel writes to (the outputs, then
    the workspace) and the kernel's dims."""

    nbytes: int
    views: tuple
    offsets: tuple
    dims: ctypes.Array
    dims_addr: int


# Plans by the shapes and dtypes of a tail's inputs: a search repeats a few
# signatures, and a launch then pays no Python layout work.
_TAIL_PLANS: dict = {}
_TAIL_PLANS_MAX = 256


def _tail_plan(lib, ins, B: int, pre: bool, has_y: bool, per_k: bool) -> _TailPlan:
    res_v, iters = ins[0], ins[6]
    packed, rows0, rows1 = ins[9], ins[10], ins[11]
    int_mask, obj_const = ins[14], ins[15]
    lo, node_y, inc_w, pkb = ins[17], ins[30], ins[23], ins[28]
    L, cap, nf = lo.shape
    m, M, n_k = node_y.shape[2], inc_w.shape[1], pkb.shape[1]
    if not 1 <= B <= cap:
        raise ValueError(f"round tail: beam {B} outside [1, cap = {cap}]")
    if L * cap * max(nf, m) >= TAIL_MAX_ELEMENTS:
        raise ValueError(f"round tail: a state field of {L * cap * max(nf, m)} elements; the "
                         f"kernel indexes at most {TAIL_MAX_ELEMENTS - 1}")
    need = int(lib.dtk_round_tail_smem_bytes(B, cap, M, int(pre), n_k, int(per_k)))
    if need > TAIL_SMEM_LIMIT:
        raise ValueError(f"round tail: a lane needs {need} bytes of shared memory (B={B}, "
                         f"cap={cap}, M={M}, n_k={n_k}, per_k={per_k}); an H100 block holds "
                         f"at most {TAIL_SMEM_LIMIT}")
    want = [DTYPE, BDTYPE, DTYPE, DTYPE, DTYPE, BDTYPE, None] + \
        ([None] * 3 if pre else [BDTYPE] * 3) + [BDTYPE if pre else None] * 4 + \
        [torch.bool, BDTYPE, torch.bool, DTYPE, DTYPE, torch.int32, BDTYPE, torch.bool, BDTYPE,
         BDTYPE, BDTYPE, BDTYPE, torch.int32, BDTYPE, BDTYPE, DTYPE, DTYPE, DTYPE, DTYPE,
         torch.bool, BDTYPE, BDTYPE] + [BDTYPE] * 4
    bad = [i for i, (t, dt) in enumerate(zip(ins, want))
           if t is not None and dt is not None and t.dtype != dt]
    if bad or iters.dtype not in (torch.int32, torch.float32):
        raise TypeError("round tail takes float32 boxes and iterates, float64 bounds, int32 k "
                        f"indices, bool masks and int32 or float32 iters_run (inputs {bad})")
    if res_v.shape != (L * B, nf) or int_mask.shape != (L, nf) or obj_const.shape != (L,):
        raise ValueError(f"round tail: LP rows {tuple(res_v.shape)}, int_mask "
                         f"{tuple(int_mask.shape)}, obj_const {tuple(obj_const.shape)} do not "
                         f"fit L={L}, beam={B}, nf={nf}")
    rd_lanes, rd_stride = 1, 0
    if not pre:
        rd_lanes = packed.shape[0] if packed.dim() == 3 else 1
        rd_stride = packed.shape[-2] * M
        if packed.shape[-1] != M or rd_lanes not in (1, L):
            raise ValueError(f"round tail: rounding blocks {tuple(packed.shape)} for L={L}")
    elif rows0.shape != (L * B,) or rows1.shape != (L * B, M):
        raise ValueError("round tail: pre-rounded rows must be (L * beam,) and (L * beam, M)")
    views, offsets, pos = tail_layout(L, cap, nf, m, M, n_k, per_k)
    offsets.append(pos)
    nbytes = pos + -(-int(lib.dtk_round_tail_ws_bytes(L, B, cap, M)) // 8) * 8
    dims = (ctypes.c_int * 13)(L, B, cap, nf, m, M, n_k, int(pre), int(has_y),
                               int(iters.dtype == torch.float32), rd_lanes, rd_stride,
                               int(per_k))
    return _TailPlan(nbytes, tuple(views), tuple(offsets), dims, ctypes.addressof(dims))


def tail_layout(L: int, cap: int, nf: int, m: int, M: int, n_k: int, per_k: bool):
    """Where the round tail writes: the new state's twenty fields and the go
    flags side by side, in per-k mode the per-k assignments and floors after
    them, each at a 128-byte boundary. Returns ``(views, offsets, end)``:
    each output's (dtype, shape, strides, element offset), its byte offset
    (None for the four per-k outputs outside per-k mode: not written) and
    the first byte after them (the workspace follows)."""
    fields = [((L, cap, nf), DTYPE), ((L, cap, nf), DTYPE), ((L, cap), torch.int32),
              ((L, cap), BDTYPE), ((L, cap), torch.bool), ((L,), BDTYPE), ((L, M), BDTYPE),
              ((L, M), BDTYPE), ((L, M), BDTYPE), ((L,), torch.int32), ((L,), BDTYPE),
              ((L, n_k), BDTYPE), ((L, cap, nf), DTYPE), ((L, cap, m), DTYPE),
              ((L, cap, nf), DTYPE), ((L, cap, nf), DTYPE), ((L, cap), torch.bool),
              ((L,), BDTYPE), ((L,), BDTYPE), ((L,), torch.bool)]
    if per_k:
        fields += [((L, n_k, M), BDTYPE)] * 3 + [((L, n_k), BDTYPE)]
    views, offsets, pos = [], [], 0
    for shape, dt in fields:
        size = torch.empty((), dtype=dt).element_size()
        stride = tuple(math.prod(shape[i + 1:]) for i in range(len(shape)))
        views.append((dt, shape, stride, pos // size))
        offsets.append(pos)
        pos += -(-math.prod(shape) * size // 128) * 128
    if not per_k:
        offsets += [None] * 4  # the per-k outputs, not written
    return views, offsets, pos


def tail_views(buf: torch.Tensor, views) -> list:
    """The typed views of :func:`tail_layout` over the byte buffer ``buf``."""
    typed = {torch.uint8: buf}
    outs = []
    for dt, shape, stride, off in views:
        flat = typed.get(dt)
        if flat is None:
            flat = typed[dt] = buf.view(dt)
        outs.append(flat.as_strided(shape, stride, off))
    return outs


def _round_tail_kernel(data, state, res, mip_gap, B, rounded, frozen, per_k=False):
    from ..kernels.build import library

    lib = library("round_tail")
    pre = rounded is not None
    has_y = pre and len(rounded) > 3
    rows = (*rounded, None)[:4] if pre else (None,) * 4
    rd = (None,) * 3 if pre else (data.Ws, data.ks, data.rd_packed)
    ins = (res.v, res.reduced, res.y_dual, res.z_dual, res.f_dual, res.bound, res.iters_run,
           *rd, *rows, data.int_mask, data.obj_const, frozen,
           state.node_lo, state.node_hi, state.node_kidx, state.node_bound, state.active,
           state.incumbent, state.inc_w, state.inc_n, state.inc_y, state.inc_kidx,
           state.dropped_bound, state.per_k_best, state.node_v, state.node_y, state.node_z,
           state.node_f, state.node_warm, state.stat_ipm_iters, state.stat_rounds,
           state.per_k_w, state.per_k_n, state.per_k_y, state.per_k_dropped)
    key = (B, has_y, per_k, frozen is None, res.v.shape, state.node_lo.shape, state.node_y.shape,
           state.inc_w.shape, state.per_k_best.shape, data.int_mask.shape,
           data.obj_const.shape, (rows[1] if pre else data.rd_packed).shape,
           *[None if t is None else t.dtype for t in ins])
    plan = _TAIL_PLANS.get(key)
    if plan is None:
        if len(_TAIL_PLANS) >= _TAIL_PLANS_MAX:
            _TAIL_PLANS.clear()
        plan = _TAIL_PLANS[key] = _tail_plan(lib, ins, B, pre, has_y, per_k)
    # Held until the launch returns (a temporary freed inside the argument
    # list could hand its memory to the next one).
    ins = [None if t is None else t.contiguous() for t in ins]
    dev = state.node_lo.device
    buf = torch.empty(plan.nbytes, dtype=torch.uint8, device=dev)
    outs = tail_views(buf, plan.views)
    base = buf.data_ptr()
    ptrs = (ctypes.c_longlong * (len(ins) + len(plan.offsets)))(
        *[0 if t is None else t.data_ptr() for t in ins],
        *[0 if o is None else base + o for o in plan.offsets])
    err = lib.dtk_round_tail(ctypes.addressof(ptrs), plan.dims_addr, float(mip_gap),
                             kernels.stream_handle(dev))
    kernels.check(err, "round_tail")
    kernels.LAUNCHES["round_tail_lanes" if state.node_lo.shape[0] > 1 else "round_tail"] += 1
    (lo, hi, kidx, bound, active, inc, inc_w, inc_n, inc_y, inc_kidx, dropped, pkb,
     nv, ny, nz, nfv, warm, st_iters, st_rounds, go) = outs[:20]
    pkw, pkn, pky, pkd = outs[20:] if per_k else (state.per_k_w, state.per_k_n,
                                                  state.per_k_y, state.per_k_dropped)
    out = SearchState(
        node_lo=lo, node_hi=hi, node_kidx=kidx, node_bound=bound, active=active,
        incumbent=inc, inc_w=inc_w, inc_n=inc_n, inc_y=inc_y, inc_kidx=inc_kidx,
        dropped_bound=dropped, per_k_best=pkb, per_k_w=pkw, per_k_n=pkn, per_k_y=pky,
        per_k_dropped=pkd, node_v=nv, node_y=ny, node_z=nz, node_f=nfv, node_warm=warm,
        stat_ipm_iters=st_iters, stat_rounds=st_rounds,
    )
    return out, go


def lp_and_round(data: SweepData, lo_r, hi_r, kidx_r, row_lane, warm, skip, ipm_iters,
                 ipm_chunk=None, lp_backend="ipm", pdhg_restart_tol=None, pdhg_dtype=None,
                 lp_trace=False, row_mesh: Optional[Mesh] = None):
    """The LP relaxations of a round's rows (each with its box ``lo_r``/
    ``hi_r``, its k index and lane) and their exact integer incumbents:
    ``(res, rounded)``, every row against its own lane's data."""
    res = lp_solve(data, lo_r, hi_r, kidx_r, row_lane, warm, skip, ipm_iters, ipm_chunk,
                   lp_backend, pdhg_restart_tol, pdhg_dtype, lp_trace, row_mesh)
    return res, round_rows(data, res, kidx_r, row_lane)


def lp_solve(data: SweepData, lo_r, hi_r, kidx_r, row_lane, warm, skip, ipm_iters,
             ipm_chunk=None, lp_backend="ipm", pdhg_restart_tol=None, pdhg_dtype=None,
             lp_trace=False, row_mesh: Optional[Mesh] = None, bc=None) -> IPMResult:
    """The LP relaxations of a round's rows, each against its own lane's
    data, on the engine ``lp_backend`` names (``bc``: the rows' b and c,
    when :func:`round_inputs` gathered them). K1 takes the sweep's
    structure, checked when it was built (``packed.static_entry``), and,
    for a shared A, its values on it."""
    M = data.rd.a.shape[-1]
    b_r, c_r = bc if bc is not None else (data.b_k[row_lane, kidx_r],
                                          data.c_k[row_lane, kidx_r])
    if lp_backend == "pdhg":
        # A as values on the sweep's structure: MoE nodes and lanes with an A
        # each per element (on a row mesh K6b's per-element entry), one
        # shared A with a batch stride of 0; a shared A on a row mesh dense.
        A_r = (data.A if data.A.dim() == 2 else data.A[0]) if data.A_values is None \
            else ElemA(node_values(data, kidx_r, row_lane), data.A_sparsity)
        batch = LPBatch(A=A_r, b=b_r, c=c_r, l=lo_r, u=hi_r)
        if row_mesh is not None and row_mesh.size > 1:
            # The row-sharded engine (K6b), the reference's mesh branch: the
            # iterate dtype follows pdhg_dtype, the tolerance the default.
            dt = resolve_pdhg_dtype(pdhg_dtype)
            if dt is not None:
                batch = cast_batch(batch, dt)
            rt = DEFAULT_RESTART_TOL if pdhg_restart_tol is None else pdhg_restart_tol
            res = sharded_pdhg(batch, row_mesh, ipm_iters, _default_tol_pdhg(batch.b.dtype),
                               rt, warm=warm, skip=skip, trace=lp_trace,
                               blocks=data.A_shards)
        else:
            res = pdhg_solve_batch(batch, iters=ipm_iters, restart_tol=pdhg_restart_tol,
                                   warm=warm, skip=skip, dtype=pdhg_dtype, trace=lp_trace)
        return cast_lp_result(res, DTYPE)
    chunk_kw = {} if ipm_chunk is None else {"chunk": ipm_chunk}
    A_r = node_A(data, kidx_r, M, row_lane)
    shared = data.A_sparsity is not None and data.A_k1_values is not None and A_r.dim() == 2
    return ipm_solve_batch(
        LPBatch(A=A_r, b=b_r, c=c_r, l=lo_r, u=hi_r),
        iters=ipm_iters, warm=warm, skip=skip, **chunk_kw,
        sparsity=data.A_sparsity, trace=lp_trace,
        _checked=data.A_sparsity is not None and data.A_checked,
        _values=data.A_k1_values if shared else None,
    )


class NodeMesh(NamedTuple):
    """K10's node mesh: the shards' devices and the sweep's data on each
    (the same object where a shard shares the search's device)."""

    mesh: Mesh
    data: Tuple[SweepData, ...]


def node_mesh_of(mesh: Mesh, data: SweepData) -> NodeMesh:
    """The sweep's data placed once on every shard's device."""
    def move(t, dev):
        if isinstance(t, torch.Tensor):
            return t.to(dev)
        if not isinstance(t, tuple):
            return t  # None, a flag, a size
        return type(t)(*(move(f, dev) for f in t))

    return NodeMesh(mesh, tuple(data if dev == data.ks.device else move(data, dev)
                                for dev in mesh.devices))


def _node_sharded(node_mesh: NodeMesh, lo_r, hi_r, kidx_r, row_lane, warm, skip,
                  lp_kw: dict):
    """K10's round: the rows split into the mesh's shards in order, each
    shard's rows through :func:`lp_and_round` on its device, the results
    gathered onto shard 0 in mesh order."""
    mesh = node_mesh.mesh
    R = lo_r.shape[0]
    S = mesh.size
    if R % S:
        raise ValueError(f"{R} beam rows do not split over {S} shards")
    per = R // S
    dev0 = lo_r.device
    parts = []
    for s, dev in enumerate(mesh.devices):
        sl = slice(s * per, (s + 1) * per)

        def on(t):
            return t[sl].to(dev)

        w = IPMWarmState(*(on(t) for t in warm))
        parts.append(lp_and_round(node_mesh.data[s], on(lo_r), on(hi_r), on(kidx_r),
                                  on(row_lane), w, on(skip), **lp_kw))

    def gather(ts):
        if ts[0] is None:
            return None
        return torch.cat([t.to(dev0) for t in ts], 0)

    res = IPMResult(*(gather([p[0][f] for p in parts]) for f in range(len(IPMResult._fields))))
    rounded = tuple(gather([p[1][f] for p in parts]) for f in range(len(parts[0][1])))
    return res, rounded


# One round-log row per executed round (``run_bnb_loop(collect_rounds=True)``,
# the reference's ``RL_COLS``/``_round_row``):
#   [expanded, live_after, incumbent, best_bound, lp_iters, executed]
RL_COLS = 6


def round_row(before: SearchState, after: SearchState, nbeam: int,
              executed: torch.Tensor) -> torch.Tensor:
    """(L, RL_COLS) float64 round-log rows from the states that bracket a
    round: the beam's active rows before it, the live nodes, the incumbent
    and the proven bound after it, the LP steps it spent, and whether the
    lane ran it (``executed``, (L,) bool). Bookkeeping only: the round is
    untouched."""
    return torch.stack([
        before.active[:, :nbeam].sum(-1).to(BDTYPE),
        after.active.sum(-1).to(BDTYPE),
        after.incumbent,
        best_bound(after),
        after.stat_ipm_iters - before.stat_ipm_iters,
        executed.to(BDTYPE),
    ], dim=1)


def root_trace_rows(lp_backend: str, lp_iters: int, root_warm_chunk: bool) -> int:
    """Trace rows of the root round's LP solve, from the chunk that round
    hands its engine: the PDHG its own chunk, a cold IPM root one chunk of
    the whole budget, a warm one the IPM's chunk."""
    if lp_backend == "pdhg":
        chunk = PDHG_DEFAULT_CHUNK
    else:
        chunk = IPM_DEFAULT_CHUNK if root_warm_chunk else lp_iters
    return n_trace_rows(lp_iters, chunk)


def run_bnb_loop(
    data: SweepData,
    state: SearchState,
    mip_gap: float,
    ipm_iters: int = IPM_ITERS,
    max_rounds: int = MAX_ROUNDS,
    beam: Optional[int] = None,
    ipm_warm_iters: Optional[int] = None,
    root_warm_chunk: bool = False,
    lp_backend: str = "ipm",
    pdhg_restart_tol: Optional[float] = None,
    pdhg_dtype: Optional[str] = None,
    per_k: bool = False,
    collect_rounds: bool = False,
    row_mesh: Optional[Mesh] = None,
    node_mesh: Optional["NodeMesh"] = None,
    root_beam: Optional[int] = None,
):
    """Root round, then warm rounds until, in every lane, the mip-gap
    certificate closes (in per-k mode: every k's own certificate,
    ``certified_per_k``), the frontier empties, or ``max_rounds`` rounds ran.

    The root round covers exactly the n_k roots at the full ``ipm_iters``
    budget (for the IPM one full-length chunk when cold, the kernel's small
    chunks when the roots carry a previous solve's iterates; the PDHG always
    uses its own chunk); later rounds warm-start from their parents at
    ``ipm_warm_iters``. A lane whose seeded state already certifies skips it.
    Each round first reads the lanes' go flags (a frontier left and no
    certificate yet) from the device, the round's one read; a lane that
    stopped stays frozen to the end, its state exactly where it settled.
    Returns ``(state, root_iters, log)`` where root_iters = (ok, v, y, z, f)
    are each lane's root-round iterates (the carried-in ones for a lane that
    skipped the root round). ``log`` is None unless ``collect_rounds``: then
    ``(rows, root_trace)``, one :func:`round_row` device tensor per executed
    round (root first) and the root round's LP convergence trace (L, n_k
    roots, :func:`root_trace_rows`, TRACE_COLS) in float32 (zeros for a lane
    that skipped it); the root round then runs its LP with the trace on.
    Nothing of it is read from the device during the loop.

    ``row_mesh`` and ``node_mesh`` go to every round (:func:`bnb_round`);
    ``root_beam`` widens the root round past the n_k roots (never below),
    as the node-sharded sweep pads it to a multiple of its mesh.
    """
    warm_iters = ipm_iters if ipm_warm_iters is None else ipm_warm_iters
    L, cap = state.node_kidx.shape
    n_k = state.per_k_best.shape[-1]
    B0 = min(cap, max(n_k, root_beam or 0))

    settled = certified_per_k if per_k else certified

    def flags(mask: torch.Tensor):
        """(device mask of the lanes that go on, whether any does, the
        frozen lanes): the one device-to-host read of a round."""
        live = mask.tolist()
        return mask, any(live), None if all(live) else ~mask

    def go(st: SearchState):
        return flags(st.active.any(-1) & ~settled(st, mip_gap))

    engine = dict(lp_backend=lp_backend, pdhg_restart_tol=pdhg_restart_tol,
                  pdhg_dtype=pdhg_dtype, per_k=per_k, row_mesh=row_mesh, node_mesh=node_mesh)
    root_iters = (
        state.node_warm[:, :B0], state.node_v[:, :B0], state.node_y[:, :B0],
        state.node_z[:, :B0], state.node_f[:, :B0],
    )
    rows: list = []
    root_trace = None
    if collect_rounds:
        root_trace = torch.zeros(
            (L, B0, root_trace_rows(lp_backend, ipm_iters, root_warm_chunk), TRACE_COLS),
            dtype=DTYPE, device=state.node_lo.device)
    # The go flags a round's tail wrote on its new state (None: test the
    # state here, as for the state passed in).
    tail_go = None
    if max_rounds >= 1:
        mask, any_go, frozen = go(state)
        if any_go:
            ok = state.active[:, :B0]
            before = state
            state, res, tail_go = _bnb_round(
                data, state, mip_gap, ipm_iters, B0, None if root_warm_chunk else ipm_iters,
                frozen=frozen, lp_trace=collect_rounds, **engine,
            )
            ran = (ok, *(t.reshape(L, B0, -1).to(DTYPE)
                         for t in (res.v, res.y_dual, res.z_dual, res.f_dual)))
            m1 = mask[:, None]
            root_iters = tuple(
                torch.where(m1 if a.dim() == 2 else m1[..., None], a, b)
                for a, b in zip(ran, root_iters)
            )
            if collect_rounds:
                rows.append(round_row(before, state, B0, mask))
                tb = res.trace_buf.reshape(root_trace.shape).to(DTYPE)
                root_trace = torch.where(mask[:, None, None, None], tb, root_trace)
    i = 1
    Bw = cap if beam is None else min(beam, cap)
    while i < max_rounds:
        mask, any_go, frozen = go(state) if tail_go is None else flags(tail_go)
        if not any_go:
            break
        before = state
        state, _, tail_go = _bnb_round(data, state, mip_gap, warm_iters, beam, None,
                                       frozen=frozen, lp_trace=False, **engine)
        if collect_rounds:
            rows.append(round_row(before, state, Bw, mask))
        i += 1
    return state, root_iters, ((rows, root_trace) if collect_rounds else None)
