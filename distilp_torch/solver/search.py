"""Batched branch-and-bound over the whole k-sweep, driven from the host.

Each round solves the LP relaxations of the best-bound-first prefix of the
frontier in one batched LP call (the IPM, kernel K1, or at fleet scale the
PDHG engine, kernel K5), rounds every LP point to an
exact integer incumbent (K2; its MoE mode for expert co-assignment), then
runs the per-row epilogue (K3: bound fold,
pruning, reduced-cost box tightening, closing, branching, child boxes, warm
carry). The scalar reductions over the beam and the stable best-bound-first
compaction are plain tensor operations. One global incumbent prunes across
every k's tree, since the answer is the minimum over k.

Ported from ``distilp_tpu/solver/backend_jax.py`` (``SearchState``,
``SweepData``, ``_root_state``, the IPM and single-device PDHG branches of
``_bnb_round`` with its MoE A scatter, ``_seed_root_bounds``,
``_cast_lp_result``, ``_best_bound``, ``_certified``, ``_run_bnb_loop``).
MoE sweeps seed the roots with the Lagrangian decomposition bounds (K7) and
an incumbent repaired from the Lagrangian primal. The reference runs the
loop as one device program; here it is a host loop that reads one boolean
from the device per round.

Precision: search arrays and IPM iterations are float32; everything the
mip-gap certificate touches (bounds, incumbents, thresholds) is float64.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..ops.decomp import DecompProblem, decomp_bound_roots
from ..ops.ipm import IPMResult, IPMWarmState, LPBatch, ipm_solve_batch
from ..ops.pdhg import pdhg_solve_batch
from .rounding import RoundingData, round_to_incumbent
from .standard_form import FRAC_TOL, IPM_ITERS, MAX_ROUNDS

DTYPE = torch.float32  # search arrays + IPM iteration dtype
BDTYPE = torch.float64  # certificate dtype
EPILOGUE_THREADS = 256


class SearchState(NamedTuple):
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
    """Device-resident arrays of one sweep, shared by every round."""

    A: torch.Tensor  # (m, nf) float32, shared by every k (the MoE base)
    b_k: torch.Tensor  # (n_k, m) float32
    c_k: torch.Tensor  # (n_k, nf) float32
    int_mask: torch.Tensor  # (nf,) bool
    ks: torch.Tensor  # (n_k,) float64
    Ws: torch.Tensor  # (n_k,) float64
    obj_const: float
    rd: RoundingData
    rd_packed: Optional[torch.Tensor] = None  # rounding.pack_rounding_data(rd)
    # MoE: the per-k expert-busy entries of A (standard_form.gky_scatter_table),
    # scattered onto each node's copy of the base at rows 4M..6M, columns
    # 2M..3M. None in dense mode (A is k-free).
    gky: Optional[torch.Tensor] = None  # (n_k, 2, M) float32


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


def root_state(
    lo_k: torch.Tensor, hi_k: torch.Tensor, M: int, cap: int, m: int,
    root_warm=None,
) -> SearchState:
    """Root frontier: one node per k. ``root_warm`` = (ok (n_k,), v, y, z, f)
    seeds the roots' IPM iterates from a previous solve's root round."""
    n_k, nf = lo_k.shape
    dev = lo_k.device

    def zeros(*shape, dtype=DTYPE):
        return torch.zeros(shape, dtype=dtype, device=dev)

    node_v, node_y, node_z, node_f = zeros(cap, nf), zeros(cap, m), zeros(cap, nf), zeros(cap, nf)
    node_warm = zeros(cap, dtype=torch.bool)
    if root_warm is not None:
        ok_w, v_w, y_w, z_w, f_w = root_warm
        node_v[:n_k] = v_w.to(DTYPE)
        node_y[:n_k] = y_w.to(DTYPE)
        node_z[:n_k] = z_w.to(DTYPE)
        node_f[:n_k] = f_w.to(DTYPE)
        node_warm[:n_k] = ok_w.to(torch.bool)
    node_lo = zeros(cap, nf)
    node_lo[:n_k] = lo_k.to(DTYPE)
    node_hi = zeros(cap, nf)
    node_hi[:n_k] = hi_k.to(DTYPE)
    node_kidx = zeros(cap, dtype=torch.int32)
    node_kidx[:n_k] = torch.arange(n_k, dtype=torch.int32, device=dev)
    active = zeros(cap, dtype=torch.bool)
    active[:n_k] = True
    inf = float("inf")
    return SearchState(
        node_lo=node_lo,
        node_hi=node_hi,
        node_kidx=node_kidx,
        node_bound=torch.full((cap,), -inf, dtype=BDTYPE, device=dev),
        active=active,
        incumbent=torch.tensor(inf, dtype=BDTYPE, device=dev),
        inc_w=zeros(M, dtype=BDTYPE),
        inc_n=zeros(M, dtype=BDTYPE),
        inc_y=zeros(M, dtype=BDTYPE),
        inc_kidx=torch.tensor(0, dtype=torch.int32, device=dev),
        dropped_bound=torch.tensor(inf, dtype=BDTYPE, device=dev),
        per_k_best=torch.full((n_k,), inf, dtype=BDTYPE, device=dev),
        per_k_w=zeros(n_k, M, dtype=BDTYPE),
        per_k_n=zeros(n_k, M, dtype=BDTYPE),
        per_k_y=zeros(n_k, M, dtype=BDTYPE),
        per_k_dropped=torch.full((n_k,), inf, dtype=BDTYPE, device=dev),
        node_v=node_v,
        node_y=node_y,
        node_z=node_z,
        node_f=node_f,
        node_warm=node_warm,
        stat_ipm_iters=zeros(dtype=BDTYPE),
        stat_rounds=zeros(dtype=BDTYPE),
    )


def best_bound(state: SearchState) -> torch.Tensor:
    inf = torch.full_like(state.node_bound, float("inf"))
    live = torch.where(state.active, state.node_bound, inf).amin()
    return torch.minimum(live, state.dropped_bound)


def certified(state: SearchState, mip_gap: float) -> torch.Tensor:
    inc = state.incumbent
    return torch.isfinite(inc) & (inc - best_bound(state) <= mip_gap * inc.abs())


def bnb_epilogue(
    lo: torch.Tensor,
    hi: torch.Tensor,
    res: IPMResult,
    parent_bound: torch.Tensor,
    active: torch.Tensor,
    obj_full: torch.Tensor,
    threshold: torch.Tensor,
    int_mask: torch.Tensor,
    obj_const: float,
    node_v: torch.Tensor,
    node_y: torch.Tensor,
    node_z: torch.Tensor,
    node_f: torch.Tensor,
    node_warm: torch.Tensor,
) -> EpilogueOut:
    """Per-row epilogue of one round (see :class:`EpilogueOut`): the CUDA
    kernel on CUDA tensors, the plain version on CPU tensors. ``threshold``
    is the (B,) pruning threshold of each row."""
    if kernels.on_cuda(lo, hi, res.v, parent_bound, obj_full, threshold, node_v):
        return _epilogue_kernel(
            lo, hi, res, parent_bound, active, obj_full, threshold, int_mask,
            obj_const, node_v, node_y, node_z, node_f, node_warm,
        )
    return bnb_epilogue_reference(
        lo, hi, res, parent_bound, active, obj_full, threshold, int_mask,
        obj_const, node_v, node_y, node_z, node_f, node_warm,
    )


def bnb_epilogue_reference(
    lo, hi, res, parent_bound, active, obj_full, threshold, int_mask,
    obj_const, node_v, node_y, node_z, node_f, node_warm,
) -> EpilogueOut:
    """Plain PyTorch version of the epilogue kernel."""
    inf = float("inf")
    B = lo.shape[0]
    rows = torch.arange(B, device=lo.device)
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
    im = int_mask[None, :]
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
    obj_const, node_v, node_y, node_z, node_f, node_warm,
) -> EpilogueOut:
    from ..kernels.build import library

    B, nf = lo.shape
    m = res.y_dual.shape[1]
    f32 = [lo, hi, res.v, res.y_dual, res.z_dual, res.f_dual,
           node_v, node_y, node_z, node_f]
    if any(t.dtype != DTYPE for t in f32):
        raise TypeError("epilogue kernel takes float32 boxes, iterates and duals")
    f64 = [res.reduced, res.bound, parent_bound, obj_full, threshold]
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
    ins = [c(lo), c(hi), c(res.v), c(res.reduced), c(res.y_dual), c(res.z_dual),
           c(res.f_dual), c(res.bound), c(parent_bound), u8(active), c(obj_full),
           c(threshold), u8(int_mask)]
    warm_ins = [c(node_v), c(node_y), c(node_z), c(node_f), u8(node_warm)]
    P = kernels.ptr
    err = library("bnb_epilogue").dtk_bnb_epilogue(
        *[P(t) for t in ins], float(obj_const), *[P(t) for t in warm_ins],
        B, nf, m, *[P(t) for t in out], EPILOGUE_THREADS,
        kernels.stream_handle(dev),
    )
    kernels.check(err, "bnb_epilogue")
    kernels.LAUNCHES["bnb_epilogue"] += 1
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
    return res._replace(**cast)


def node_A(data: SweepData, kidx: torch.Tensor, M: int) -> torch.Tensor:
    """The constraint matrix of each node: the shared (m, nf) A in dense
    mode; in MoE mode a contiguous (B, m, nf) copy of the base per node with
    its k's 2M expert-busy entries scattered in (K1's per-element route)."""
    if data.gky is None:
        return data.A
    B = kidx.shape[0]
    m, nf = data.A.shape
    A_p = data.A.expand(B, m, nf).clone()
    g_p = data.gky[kidx]  # (B, 2, M)
    ar = torch.arange(M, device=data.A.device)
    A_p[:, 4 * M + ar, 2 * M + ar] = g_p[:, 0, :]
    A_p[:, 5 * M + ar, 2 * M + ar] = g_p[:, 1, :]
    return A_p


def seed_root_bounds(
    state: SearchState,
    data: SweepData,
    p32: DecompProblem,
    p64: DecompProblem,
    decomp_steps: int,
    init_duals=None,
):
    """Root Lagrangian decomposition bounds (K7) into the roots' node
    bounds, and, on cold solves (``decomp_steps > 0``), each k's
    Lagrangian-primal cell repaired to a feasible placement (K2's hint mode,
    ``e_max + 4`` repair steps) as incumbent candidates. Returns
    ``(state, duals, raw_bounds, m_y)``; the raw bounds exclude
    ``obj_const``. A warm tick (``decomp_steps == 0``) only re-evaluates the
    bound at ``init_duals``: its incumbent is the previous optimum."""
    n_k = data.ks.shape[0]
    M = state.inc_w.shape[0]
    nf = state.node_lo.shape[1]
    raw, w_star, n_star, y_star, duals, m_y = decomp_bound_roots(
        p32, p64, data.rd, decomp_steps, init_duals
    )
    node_bound = state.node_bound.clone()
    node_bound[:n_k] = raw + data.obj_const
    state = state._replace(node_bound=node_bound)
    if decomp_steps == 0:
        return state, duals, raw, m_y

    v_hint = torch.zeros((n_k, nf), dtype=BDTYPE, device=raw.device)
    v_hint[:, :M] = w_star
    v_hint[:, M : 2 * M] = n_star
    v_hint[:, 2 * M : 3 * M] = y_star
    lag_obj, lag_w, lag_n, lag_y = round_to_incumbent(
        v_hint, data.Ws, data.ks, data.rd, data.rd_packed, moe=True,
        y_steps=p64.e_max + 4,
    )
    lag_obj = lag_obj + data.obj_const
    jbest = lag_obj.argmin()
    better = lag_obj[jbest] < state.incumbent
    clean = torch.where(torch.isfinite(lag_obj), lag_obj, float("inf"))
    seeded_k = (clean < state.per_k_best)[:, None]
    state = state._replace(
        incumbent=torch.where(better, lag_obj[jbest], state.incumbent),
        inc_w=torch.where(better, lag_w[jbest], state.inc_w),
        inc_n=torch.where(better, lag_n[jbest], state.inc_n),
        inc_y=torch.where(better, lag_y[jbest], state.inc_y),
        inc_kidx=torch.where(better, jbest.to(torch.int32), state.inc_kidx),
        per_k_best=torch.minimum(state.per_k_best, clean),
        per_k_w=torch.where(seeded_k, lag_w, state.per_k_w),
        per_k_n=torch.where(seeded_k, lag_n, state.per_k_n),
        per_k_y=torch.where(seeded_k, lag_y, state.per_k_y),
    )
    return state, duals, raw, m_y


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
) -> Tuple[SearchState, IPMResult]:
    """One batched branch-and-bound round over the frontier prefix of
    ``beam`` rows (rows past it pass through with their parent bound).
    ``ipm_iters`` is the LP budget of whichever engine ``lp_backend``
    names; ``ipm_chunk`` (the IPM's cold-root full-length chunk) is never
    passed to the PDHG, whose convergence point inside its budget is unknown
    even cold. Returns the new state and the beam rows' raw LP result."""
    M = state.inc_w.shape[0]
    cap = state.node_lo.shape[0]
    n_k = state.per_k_best.shape[0]
    B = cap if beam is None else min(beam, cap)
    inf = float("inf")

    lo_p = state.node_lo[:B]
    hi_p = state.node_hi[:B]
    kidx_p = state.node_kidx[:B].long()
    active_p = state.active[:B]
    warm = IPMWarmState(
        v=state.node_v[:B],
        y=state.node_y[:B],
        z=state.node_z[:B],
        f=state.node_f[:B],
        ok=state.node_warm[:B],
    )
    moe = data.gky is not None
    lp_batch = LPBatch(A=node_A(data, kidx_p, M), b=data.b_k[kidx_p], c=data.c_k[kidx_p],
                       l=lo_p, u=hi_p)
    if lp_backend == "pdhg":
        res = pdhg_solve_batch(
            lp_batch, iters=ipm_iters, restart_tol=pdhg_restart_tol, warm=warm,
            skip=~active_p, dtype=pdhg_dtype,
        )
        res = cast_lp_result(res, data.A.dtype)
    else:
        chunk_kw = {} if ipm_chunk is None else {"chunk": ipm_chunk}
        res = ipm_solve_batch(
            lp_batch, iters=ipm_iters, warm=warm, skip=~active_p, **chunk_kw,
        )

    # Exact integer incumbents from every processed row's LP point.
    rounded = round_to_incumbent(
        res.v, data.Ws[kidx_p], data.ks[kidx_p], data.rd, data.rd_packed, moe=moe
    )
    obj_lin, w_int, n_int = rounded[:3]
    obj_full = torch.where(active_p, obj_lin + data.obj_const, inf)
    best_i = obj_full.argmin()
    best_obj = obj_full[best_i]
    better = best_obj < state.incumbent
    incumbent = torch.where(better, best_obj, state.incumbent)
    inc_w = torch.where(better, w_int[best_i], state.inc_w)
    inc_n = torch.where(better, n_int[best_i], state.inc_n)
    inc_y = torch.where(better, rounded[3][best_i], state.inc_y) if moe else state.inc_y
    inc_kidx = torch.where(better, kidx_p[best_i].to(torch.int32), state.inc_kidx)
    round_best_k = torch.full((n_k,), inf, dtype=BDTYPE, device=obj_full.device)
    round_best_k = round_best_k.scatter_reduce(0, kidx_p, obj_full, "amin")
    per_k_best = torch.minimum(state.per_k_best, round_best_k)

    # Prune threshold: a node survives only if its bound can still beat the
    # incumbent by more than the relative gap (+inf with no incumbent yet).
    threshold = torch.where(
        torch.isfinite(incumbent), incumbent - mip_gap * incumbent.abs(), inf
    )
    ep = bnb_epilogue(
        lo_p, hi_p, res, state.node_bound[:B], active_p, obj_full,
        threshold.expand(B), data.int_mask, data.obj_const,
        warm.v, warm.y, warm.z, warm.f, warm.ok,
    )

    # Unprocessed rows pass through, still subject to the new threshold.
    rest_bound = state.node_bound[B:]
    rest_active = state.active[B:] & (rest_bound < threshold)
    child_lo = torch.cat([ep.lo_a, ep.lo_b, state.node_lo[B:]])
    child_hi = torch.cat([ep.hi_a, ep.hi_b, state.node_hi[B:]])
    child_kidx = torch.cat([state.node_kidx[:B], state.node_kidx[:B], state.node_kidx[B:]])
    child_bound = torch.cat([ep.bound, ep.bound, rest_bound])
    child_active = torch.cat([ep.survive, ep.survive, rest_active])
    child_v = torch.cat([ep.v_new, ep.v_new, state.node_v[B:]])
    child_y = torch.cat([ep.y_new, ep.y_new, state.node_y[B:]])
    child_z = torch.cat([ep.z_new, ep.z_new, state.node_z[B:]])
    child_f = torch.cat([ep.f_new, ep.f_new, state.node_f[B:]])
    child_warm = torch.cat([ep.warm_new, ep.warm_new, state.node_warm[B:]])

    # Best-bound-first compaction back to the capacity. Both children of a
    # node share one bound; the stable sort keeps child A ahead of child B.
    sort_key = torch.where(child_active, child_bound, inf)
    order = torch.argsort(sort_key, stable=True)
    keep = order[:cap]
    spill = order[cap:]
    spill_live = torch.where(child_active[spill], child_bound[spill], inf)
    dropped_bound = torch.minimum(state.dropped_bound, spill_live.amin())

    out = SearchState(
        node_lo=child_lo[keep],
        node_hi=child_hi[keep],
        node_kidx=child_kidx[keep],
        node_bound=child_bound[keep],
        active=child_active[keep],
        incumbent=incumbent,
        inc_w=inc_w,
        inc_n=inc_n,
        inc_y=inc_y,
        inc_kidx=inc_kidx,
        dropped_bound=dropped_bound,
        per_k_best=per_k_best,
        per_k_w=state.per_k_w,
        per_k_n=state.per_k_n,
        per_k_y=state.per_k_y,
        per_k_dropped=state.per_k_dropped,
        node_v=child_v[keep],
        node_y=child_y[keep],
        node_z=child_z[keep],
        node_f=child_f[keep],
        node_warm=child_warm[keep],
        stat_ipm_iters=state.stat_ipm_iters + res.iters_run.sum().to(BDTYPE),
        stat_rounds=state.stat_rounds + 1.0,
    )
    return out, res


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
):
    """Root round, then warm rounds until the mip-gap certificate closes,
    the frontier empties, or ``max_rounds`` rounds ran.

    The root round covers exactly the n_k roots at the full ``ipm_iters``
    budget (for the IPM one full-length chunk when cold, the kernel's small
    chunks when the roots carry a previous solve's iterates; the PDHG always
    uses its own chunk); later rounds warm-start from their parents at
    ``ipm_warm_iters``. It is skipped when the seeded
    state already certifies. Returns ``(state, root_iters)`` where
    root_iters = (ok, v, y, z, f) are the root round's iterates (the
    carried-in ones when the root round was skipped).
    """
    warm_iters = ipm_iters if ipm_warm_iters is None else ipm_warm_iters
    n_k = state.per_k_best.shape[0]
    cap = state.node_lo.shape[0]
    B0 = min(cap, n_k)

    def go(st: SearchState) -> bool:
        # The one device-to-host read of a round.
        return bool((st.active.any() & ~certified(st, mip_gap)).item())

    engine = dict(lp_backend=lp_backend, pdhg_restart_tol=pdhg_restart_tol,
                  pdhg_dtype=pdhg_dtype)
    root_iters = (
        state.node_warm[:B0], state.node_v[:B0], state.node_y[:B0],
        state.node_z[:B0], state.node_f[:B0],
    )
    if max_rounds >= 1 and go(state):
        ok = state.active[:B0]
        state, res = bnb_round(
            data, state, mip_gap, ipm_iters=ipm_iters, beam=B0,
            ipm_chunk=None if root_warm_chunk else ipm_iters, **engine,
        )
        root_iters = (
            ok, res.v.to(DTYPE), res.y_dual.to(DTYPE), res.z_dual.to(DTYPE),
            res.f_dual.to(DTYPE),
        )
    i = 1
    while i < max_rounds and go(state):
        state, _ = bnb_round(data, state, mip_gap, ipm_iters=warm_iters, beam=beam,
                             **engine)
        i += 1
    return state, root_iters
