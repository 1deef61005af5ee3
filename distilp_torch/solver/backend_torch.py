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
contract. MoE sweeps (IPM engine) add the Lagrangian decomposition root
bounds (K7), from scratch or, on a warm tick, at the previous solve's
multipliers (``duals``), which the result carries on.
"""

from __future__ import annotations

import time
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.decomp import decomp_problem
from .assemble import MilpArrays, VarLayout
from .coeffs import HaldaCoeffs
from .result import ILPResult
from .rounding import pack_rounding_data, round_to_incumbent, rounding_data
from .search import (
    BDTYPE,
    SweepData,
    best_bound,
    root_state,
    run_bnb_loop,
    seed_root_bounds,
)
from .standard_form import (
    DECOMP_STEPS_COLD,
    DECOMP_STEPS_WARM,
    MOE_LOCAL_MOVES_WARM,
    StandardForm,
    build_standard_form,
    gky_scatter_table,
    resolve_search_params,
    rounding_arrays_np,
)


def resolve_device(device=None) -> torch.device:
    """``None`` means the first CUDA device; raises without a GPU (the solve
    never drops to the CPU on its own)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "halda_solve(backend='torch') runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch versions "
                "of the kernels, or backend='cpu' for the HiGHS oracle"
            )
        return torch.device("cuda")
    return torch.device(device)


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
    the PDHG engine's budget, restart factor and iterate precision;
    ``mesh_shards`` above 1 (the multi-GPU engine) raises, and so does a MoE
    sweep on the PDHG engine.
    """
    if coeffs is None:
        raise ValueError("solve_sweep_torch requires the HaldaCoeffs used for assembly")
    M = arrays.layout.M
    feasible = [(k, W) for (k, W) in kWs if W >= M]
    results: List[Optional[ILPResult]] = [None] * len(kWs)
    if not feasible:
        return results, None
    dev = resolve_device(device)

    t0 = time.perf_counter()
    sf = build_standard_form(arrays, coeffs, feasible)
    n_k = len(sf.ks)
    (
        cap, beam, ipm_iters, ipm_warm_iters, max_rounds, engine, mesh_shards,
        pdhg_dtype,
    ) = resolve_search_params(
        sf.moe, n_k, node_cap, beam, ipm_iters, max_rounds,
        ipm_warm_iters=ipm_warm_iters, lp_backend=lp_backend,
        pdhg_iters=pdhg_iters, M=M, mesh_shards=mesh_shards,
        pdhg_dtype=pdhg_dtype,
    )
    if mesh_shards > 1:
        raise NotImplementedError(
            f"mesh_shards={mesh_shards}: the row-sharded PDHG runs across GPUs, "
            f"a later slice of the port (ROADMAP.md A13)"
        )
    if sf.moe and engine == "pdhg":
        raise NotImplementedError(
            "MoE co-assignment on the PDHG engine: its kernel takes one A shared "
            "by the batch, and each MoE node has its own (ROADMAP.md A15); pass "
            "lp_backend='ipm'"
        )
    if timings is not None:
        timings["lp_backend"] = engine
        timings["mesh_shards"] = mesh_shards
    E = int(arrays.moe.E) if sf.moe else 0
    warm_tuple, duals_tuple, root_warm_tuple = warm_inputs(sf, warm, feasible, E)
    rd_np = rounding_arrays_np(coeffs, arrays.moe)
    host = device_arrays(sf, rd_np["g_raw"])
    if sf.moe:
        # The decomposition bound certifies wide-expert instances (their LP
        # root gap is structural). A warm tick with both the stored
        # multipliers and a warm incumbent only re-evaluates it.
        w_max = max(W for _, W in feasible)
        decomp_steps = (
            DECOMP_STEPS_WARM
            if duals_tuple is not None and warm_tuple is not None
            else DECOMP_STEPS_COLD
        )
    t1 = time.perf_counter()

    tensors = {k: torch.as_tensor(v, device=dev) for k, v in host.items()}
    rd = rounding_data(rd_np, dev)
    data = SweepData(
        A=tensors["A"],
        b_k=tensors["b_k"],
        c_k=tensors["c_k"],
        int_mask=tensors["int_mask"],
        ks=torch.as_tensor(np.asarray(sf.ks, np.float64), device=dev),
        Ws=torch.as_tensor(np.asarray(sf.Ws, np.float64), device=dev),
        obj_const=float(sf.obj_const),
        rd=rd,
        rd_packed=pack_rounding_data(rd),
        gky=tensors.get("gky"),
    )
    m, nf = data.A.shape
    root_warm = None
    if root_warm_tuple is not None:
        root_warm = tuple(torch.as_tensor(a, device=dev) for a in root_warm_tuple)
        root_warm = (root_warm[0] > 0.5, *root_warm[1:])
    state = root_state(tensors["lo_k"], tensors["hi_k"], M, cap, m, root_warm)
    t2 = time.perf_counter()

    duals_t = None
    if sf.moe:
        problems = [
            decomp_problem(rd_np, sf.ks, sf.Ws, w_max, E, dt, dev)
            for dt in (torch.float32, torch.float64)
        ]
        state, duals_t, raw_bounds, _ = seed_root_bounds(
            state, data, *problems, decomp_steps, init_duals=duals_tuple
        )
    t_decomp = time.perf_counter()
    if warm_tuple is not None:
        state = _seed_warm(state, data, warm_tuple, M, nf, sf.moe)

    state, root_iters = run_bnb_loop(
        data, state, mip_gap, ipm_iters=ipm_iters, max_rounds=max_rounds,
        beam=beam, ipm_warm_iters=ipm_warm_iters,
        root_warm_chunk=root_warm_tuple is not None, lp_backend=engine,
        pdhg_restart_tol=pdhg_restart_tol, pdhg_dtype=pdhg_dtype,
    )
    head_parts = [
        torch.stack([
            state.incumbent, best_bound(state), state.inc_kidx.to(BDTYPE),
            state.stat_ipm_iters, state.stat_rounds,
        ]),
        state.inc_w, state.inc_n, state.inc_y, state.per_k_best,
    ]
    if duals_t is not None:
        head_parts += [t.reshape(-1) for t in duals_t] + [raw_bounds]
    head = torch.cat(head_parts).cpu().numpy()
    ok_r, v_r, y_r, z_r, f_r = (t[:n_k].to(BDTYPE).cpu().numpy() for t in root_iters)
    t3 = time.perf_counter()

    stats = {
        "build_sf_ms": (t1 - t0) * 1e3,
        "upload_ms": (t2 - t1) * 1e3,
        "solve_ms": (t3 - t2) * 1e3,
        "ipm_iters_executed": float(head[3]),
        "bnb_rounds": float(head[4]),
    }
    if sf.moe:
        # Host time to enqueue the bound (the ascent reads nothing back).
        stats["decomp_steps"] = decomp_steps
        stats["decomp_enqueue_ms"] = (t_decomp - t2) * 1e3
    if timings is not None:
        timings.update(stats)
    incumbent, bound = float(head[0]), float(head[1])
    if debug:
        print(
            f"    [torch] incumbent={incumbent:.6f} bound={bound:.6f} "
            f"ipm_iters={head[3]:.0f} rounds={head[4]:.0f} "
            f"solve={stats['solve_ms']:.2f}ms"
        )
    if not np.isfinite(incumbent):
        return results, None

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
            stacklevel=2,
        )
    inc_k_idx = int(head[2])
    o = 5
    inc_w = [int(round(x)) for x in head[o : o + M]]
    inc_n = [int(round(x)) for x in head[o + M : o + 2 * M]]
    inc_y = [int(round(x)) for x in head[o + 2 * M : o + 3 * M]] if sf.moe else None
    o += 3 * M
    per_k_best = head[o : o + n_k]
    o += n_k
    out_duals = None
    if duals_t is not None:
        # Persisted on the winning result: the next tick re-evaluates the
        # bound at these multipliers (the JAX package reads the same keys).
        out_duals = {
            "lam": head[o : o + n_k].tolist(),
            "mu": head[o + n_k : o + 2 * n_k].tolist(),
            "tau": head[o + 2 * n_k : o + 2 * n_k + n_k * M].reshape(n_k, M).tolist(),
            "root_bounds": head[o + 2 * n_k + n_k * M : o + 3 * n_k + n_k * M].tolist(),
        }
    ipm_state = None
    if np.any(ok_r > 0.5):
        ipm_state = {"ok": ok_r > 0.5, "v": v_r, "y": y_r, "z": z_r, "f": f_r}

    best: Optional[ILPResult] = None
    pos_of = {kW: i for i, kW in enumerate(kWs)}
    for j, (k, W) in enumerate(feasible):
        obj_j = float(per_k_best[j])
        if not np.isfinite(obj_j):
            continue
        if j == inc_k_idx:
            best = ILPResult(
                k=k, w=inc_w, n=inc_n, y=inc_y, obj_value=obj_j, certified=is_cert,
                gap=gap, duals=out_duals, ipm_state=ipm_state,
            )
            results[pos_of[(k, W)]] = best
        else:
            results[pos_of[(k, W)]] = ILPResult(k=k, obj_value=obj_j, certified=False)
    return results, best


def _seed_warm(state, data: SweepData, warm_tuple, M: int, nf: int, moe: bool = False):
    """Re-price a previous assignment exactly under THIS sweep's
    coefficients and seed the incumbent with it (an infeasible hint prices
    to +inf and leaves the state cold). In MoE mode the re-pricing runs
    the rounding kernel's short warm move search."""
    kidx, w, n, y = warm_tuple
    dev = data.A.device
    n_k = data.ks.shape[0]
    kidx = min(max(int(kidx), 0), n_k - 1)
    v = torch.zeros((1, nf), dtype=BDTYPE, device=dev)
    v[0, :M] = torch.as_tensor(np.asarray(w, np.float64), device=dev)
    v[0, M : 2 * M] = torch.as_tensor(np.asarray(n, np.float64), device=dev)
    if moe:
        v[0, 2 * M : 3 * M] = torch.as_tensor(np.asarray(y, np.float64), device=dev)
    out = round_to_incumbent(
        v, data.Ws[kidx : kidx + 1], data.ks[kidx : kidx + 1], data.rd, data.rd_packed,
        moe=moe, moves=MOE_LOCAL_MOVES_WARM,
    )
    obj, w_rep, n_rep = out[:3]
    y_rep = out[3] if moe else state.inc_y[None]
    warm_obj = obj[0] + data.obj_const
    seeded = torch.isfinite(warm_obj) & (warm_obj < state.incumbent)
    clean = torch.where(torch.isfinite(warm_obj), warm_obj, float("inf"))
    seeded_k = clean < state.per_k_best[kidx]
    per_k_best = state.per_k_best.clone()
    per_k_best[kidx] = torch.minimum(per_k_best[kidx], clean)
    per_k = {}
    for name, rep in (("per_k_w", w_rep), ("per_k_n", n_rep), ("per_k_y", y_rep)):
        t = getattr(state, name).clone()
        t[kidx] = torch.where(seeded_k, rep[0], t[kidx])
        per_k[name] = t
    return state._replace(
        incumbent=torch.where(seeded, warm_obj, state.incumbent),
        inc_w=torch.where(seeded, w_rep[0], state.inc_w),
        inc_n=torch.where(seeded, n_rep[0], state.inc_n),
        inc_y=torch.where(seeded, y_rep[0], state.inc_y),
        inc_kidx=torch.where(
            seeded, torch.tensor(kidx, dtype=torch.int32, device=dev), state.inc_kidx
        ),
        per_k_best=per_k_best,
        **per_k,
    )
