"""Public solver API of the port: ``halda_solve`` on a CUDA device.

``backend='torch'`` (default) — batched branch-and-bound with the hand-written
IPM or PDHG, rounding and epilogue kernels on ``device`` (None = ``cuda``; raises when
no GPU is present: it never drops to the CPU on its own). Passing
``device='cpu'`` runs the same search through the kernels' plain PyTorch
versions, which is what the CPU tests do.
``backend='cpu'`` — the per-k scipy/HiGHS branch-and-cut oracle.

Same signature and result type as ``distilp_tpu.solver.halda_solve`` plus
``device``; the knobs of parts the port does not have yet (the multi-GPU
mesh, convergence traces, the MoE margin chain, MoE on the PDHG engine)
raise when set.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from ..common import DeviceProfile, ModelProfile, kv_bits_to_factor
from .assemble import assemble
from .backend_cpu import Infeasible, solve_fixed_k_cpu
from .backend_torch import resolve_device, solve_sweep_torch
from .coeffs import assign_sets, build_coeffs, valid_factors_of_L
from .moe import adjust_model, build_moe_arrays, resolve_moe
from .result import HALDAResult, ILPResult
from .standard_form import BEAM, IPM_ITERS, MAX_ROUNDS, NODE_CAP, default_pdhg_iters

Backend = str  # 'torch' | 'cpu'


def _warm_to_ilp(warm: Optional[HALDAResult]) -> Optional[ILPResult]:
    if warm is None:
        return None
    return ILPResult(
        k=warm.k, w=warm.w, n=warm.n, y=warm.y,
        obj_value=warm.obj_value, duals=warm.duals,
        ipm_state=warm.ipm_state,
    )


def _best_to_result(best: ILPResult, sets) -> HALDAResult:
    return HALDAResult(
        w=list(best.w),
        n=list(best.n),
        k=best.k,
        obj_value=best.obj_value,
        sets={name: list(v) for name, v in sets.items()},
        y=list(best.y) if best.y is not None else None,
        certified=best.certified,
        gap=best.gap,
        duals=best.duals,
        ipm_state=best.ipm_state,
    )


def _build_instance(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    k_candidates: Optional[Iterable[int]],
    kv_bits: str,
    moe: Optional[bool],
    load_factors: Optional[Sequence[float]],
    batch_size: int = 1,
):
    """Validation + instance assembly: (Ks, sets, coeffs, arrays). In MoE
    mode the dense (w, n) costs come from the expert-free adjusted profile
    and the expert block (y) carries the routed experts, priced at
    ``load_factors`` (one per device) when given."""
    use_moe = resolve_moe(model, moe)
    if use_moe and batch_size != 1:
        raise ValueError(
            "batch_size pricing is dense-only: the MoE expert busy model "
            "prices per-active-expert-per-token compute at batch 1, so a "
            "batch-N dense half would silently mix batches in one "
            "objective. Pass moe=False to price a MoE profile's dense "
            "slice at batch N, or keep batch_size=1."
        )
    if k_candidates:
        Ks = sorted(set(int(k) for k in k_candidates))
        bad = [k for k in Ks if k <= 0 or model.L % k != 0 or k == model.L]
        if bad:
            raise ValueError(
                f"k candidates must be proper factors of L={model.L}; invalid: {bad}"
            )
    else:
        Ks = valid_factors_of_L(model.L)
    kv_factor = kv_bits_to_factor(kv_bits)
    sets = assign_sets(devs)
    if use_moe:
        coeffs = build_coeffs(devs, adjust_model(model), kv_factor, sets, batch_size)
        arrays = assemble(
            coeffs, moe=build_moe_arrays(devs, model, load_factors=load_factors)
        )
    else:
        coeffs = build_coeffs(devs, model, kv_factor, sets, batch_size)
        arrays = assemble(coeffs)
    return Ks, sets, coeffs, arrays


def halda_solve(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    k_candidates: Optional[Iterable[int]] = None,
    mip_gap: Optional[float] = 1e-4,
    plot: bool = False,
    debug: bool = False,
    kv_bits: str = "8bit",
    backend: Backend = "torch",
    time_limit: Optional[float] = 3600.0,
    moe: Optional[bool] = None,
    warm: Optional[HALDAResult] = None,
    max_rounds: Optional[int] = None,
    beam: Optional[int] = None,
    ipm_iters: Optional[int] = None,
    ipm_warm_iters: Optional[int] = None,
    node_cap: Optional[int] = None,
    timings: Optional[dict] = None,
    load_factors: Optional[Sequence[float]] = None,
    batch_size: int = 1,
    margin_state: Optional[dict] = None,
    lp_backend: str = "auto",
    pdhg_iters: Optional[int] = None,
    pdhg_restart_tol: Optional[float] = None,
    mesh_shards: Optional[int] = None,
    pdhg_dtype: Optional[str] = None,
    convergence: Optional[dict] = None,
    device=None,
) -> HALDAResult:
    """Pick the best (k, w, n) placement over all candidate segment counts.

    Search controls (None = problem-class defaults, see
    ``standard_form.default_search_params``): ``max_rounds``, ``beam``,
    ``ipm_iters`` (cold root budget), ``ipm_warm_iters`` (every later
    round), ``node_cap``. ``warm`` seeds the search with a previous solve's
    assignment, re-priced exactly under the current profiles, and its root
    IPM iterates (``ipm_state``).

    LP engine: ``lp_backend`` 'ipm', 'pdhg' or 'auto' (PDHG at 128 devices
    and more); ``pdhg_iters`` (cold budget; warm rounds a quarter of it),
    ``pdhg_restart_tol`` and ``pdhg_dtype`` ('f32'/'f64' iterates) set the
    PDHG engine. ``mesh_shards`` above 1 (multi-GPU) is a later slice.

    Certification escalation: a solve that misses the mip-gap certificate
    while every search knob is None retries once at the escalated budget
    (cap 256 / beam 16; the IPM at 26 iterations in every round, the PDHG at
    4x its default budget and in float64 when it ran 'f32'), warm-seeded from
    the uncertified incumbent; ``timings['escalated']`` reports it.

    ``moe=None`` co-assigns routed experts (``y``, one count per device)
    when the profile carries MoE metrics (``moe=False`` forces the dense
    formulation); ``load_factors`` prices each device's experts at a
    realized load. MoE solves run the IPM engine (``lp_backend='auto'``
    below 128 devices, or ``'ipm'``) with the Lagrangian decomposition root
    bounds; a ``warm`` result that carries ``duals`` re-evaluates the bound
    at them instead of running the ascent.

    Returns the assignment minimizing the modeled per-round latency with its
    certificate; raises ``RuntimeError`` if no k admits a feasible one.
    """
    if margin_state is not None:
        raise NotImplementedError(
            "margin_state (the MoE margin fast path of streaming ticks) is not "
            "part of the port yet (ROADMAP.md A5)"
        )
    later = {"convergence": convergence}
    unsupported = [k for k, v in later.items() if v is not None]
    if plot:
        unsupported.append("plot")
    if unsupported:
        raise NotImplementedError(
            f"{unsupported}: not part of the port yet (later slices)"
        )
    import time as _time

    t0 = _time.perf_counter()
    Ks, sets, coeffs, arrays = _build_instance(
        devs, model, k_candidates, kv_bits, moe, load_factors, batch_size
    )
    if timings is not None:
        timings["build_ms"] = (_time.perf_counter() - t0) * 1e3

    per_k_objs: List[Tuple[int, Optional[float]]] = []
    best: Optional[ILPResult] = None
    gap = mip_gap if mip_gap is not None else 1e-4

    if backend == "torch":
        dev = resolve_device(device)
        tm = timings if timings is not None else {}
        kWs = [(k, model.L // k) for k in Ks]
        results, best = solve_sweep_torch(
            arrays, kWs, mip_gap=gap, coeffs=coeffs, debug=debug,
            warm=_warm_to_ilp(warm), max_rounds=max_rounds, beam=beam,
            ipm_iters=ipm_iters, ipm_warm_iters=ipm_warm_iters,
            node_cap=node_cap, timings=tm, lp_backend=lp_backend,
            pdhg_iters=pdhg_iters, pdhg_restart_tol=pdhg_restart_tol,
            mesh_shards=mesh_shards, pdhg_dtype=pdhg_dtype, device=dev,
        )
        defaults_used = all(
            v is None
            for v in (max_rounds, beam, ipm_iters, ipm_warm_iters, node_cap,
                      pdhg_iters)
        )
        # Only a dense solve escalates: the MoE class already runs the
        # largest budget (as the reference does).
        if (best is not None and not best.certified and defaults_used
                and arrays.moe is None):
            engine = tm.get("lp_backend", "ipm")
            if debug:
                print(
                    f"  escalating: gap {best.gap} uncertified at default "
                    f"budgets; retrying at cap={NODE_CAP} beam={BEAM} "
                    f"engine={engine}"
                )
            # Per-engine escalated budgets: the IPM runs its full 26
            # iterations in every round; the PDHG 4x its size-aware default
            # (its warm rounds a quarter of that) and, after an 'f32' run,
            # float64 iterates.
            esc_kw = (
                {
                    "pdhg_iters": 4 * default_pdhg_iters(len(devs)),
                    "pdhg_dtype": "f64" if pdhg_dtype == "f32" else pdhg_dtype,
                    "mesh_shards": mesh_shards,
                }
                if engine == "pdhg"
                else {"ipm_iters": IPM_ITERS, "ipm_warm_iters": IPM_ITERS}
            )
            results2, best2 = solve_sweep_torch(
                arrays, kWs, mip_gap=gap, coeffs=coeffs, debug=debug,
                warm=best, max_rounds=MAX_ROUNDS, beam=BEAM, node_cap=NODE_CAP,
                timings=tm, lp_backend=engine, pdhg_restart_tol=pdhg_restart_tol,
                device=dev, **esc_kw,
            )
            if best2 is not None:
                results, best = results2, best2
            tm["escalated"] = 1
        for k, res in zip(Ks, results):
            per_k_objs.append((k, res.obj_value if res is not None else None))
            if debug:
                obj = f"{res.obj_value:.6f}" if res is not None else "infeasible"
                print(f"  k={k:<4d}  obj={obj}")
    elif backend == "cpu":
        for k in Ks:
            try:
                res = solve_fixed_k_cpu(
                    arrays, k, model.L // k, time_limit=time_limit, mip_gap=mip_gap
                )
            except Infeasible:
                per_k_objs.append((k, None))
                if debug:
                    print(f"  k={k:<4d}  obj=infeasible")
                continue
            per_k_objs.append((k, res.obj_value))
            if debug:
                print(f"  k={k:<4d}  obj={res.obj_value:.6f}")
            if best is None or res.obj_value < best.obj_value:
                best = res
    else:
        raise ValueError(f"Unknown backend {backend!r}; expected 'torch' or 'cpu'")

    if best is None:
        raise RuntimeError("No feasible MILP found for any k.")
    return _best_to_result(best, sets)
