"""Public solver API of the port: ``halda_solve``, ``halda_solve_per_k``,
``halda_solve_async`` and ``halda_solve_scenarios`` on a CUDA device.

``backend='torch'`` (default) — batched branch-and-bound with the hand-written
IPM or PDHG, rounding and epilogue kernels on ``device`` (None = ``cuda``; raises when
no GPU is present: it never drops to the CPU on its own). Passing
``device='cpu'`` runs the same search through the kernels' plain PyTorch
versions, which is what the CPU tests do.
``backend='cpu'`` — the per-k scipy/HiGHS branch-and-cut oracle.

Same signatures and result types as the JAX package's functions of these
names plus ``device`` (the JAX package's ``backend='jax'`` is ``'torch'``
here); ``plot=True`` draws the k-objective curve (``solver.plotter``,
matplotlib). ``mesh_shards`` above 1 row-partitions every PDHG
relaxation over a mesh of that many shards (``distilp_torch.parallel``).
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from ..common import DeviceProfile, ModelProfile, kv_bits_to_factor
from .assemble import assemble
from .backend_cpu import Infeasible, solve_fixed_k_cpu
from .backend_torch import (
    PendingSweep,
    collect_sweep,
    resolve_device,
    solve_sweep_scenarios,
    solve_sweep_torch,
)
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
    PDHG engine. ``mesh_shards`` above 1 row-partitions every PDHG relaxation
    over that many shards (K6b): the first devices of ``device``'s type, or a
    virtual mesh the process declared
    (:func:`distilp_torch.parallel.force_virtual_devices`); MoE nodes run
    its per-element entry, each shard's rows of every node's A on the
    sweep's sparse structure.

    Certification escalation: a solve that misses the mip-gap certificate
    while every search knob is None retries once at the escalated budget
    (cap 256 / beam 16; the IPM at 26 iterations in every round, the PDHG at
    4x its default budget and in float64 when it ran 'f32'), warm-seeded from
    the uncertified incumbent; ``timings['escalated']`` reports it.

    ``moe=None`` co-assigns routed experts (``y``, one count per device)
    when the profile carries MoE metrics (``moe=False`` forces the dense
    formulation); ``load_factors`` prices each device's experts at a
    realized load. MoE solves take the Lagrangian decomposition root
    bounds, on either engine (each node's A is its own on the PDHG: K5's
    per-element entry); a ``warm`` result that carries ``duals``
    re-evaluates the bound at them instead of running the ascent.

    ``convergence``: pass a dict (``backend='torch'``) to receive the
    solver's convergence telemetry: the per-round search log and the root
    LP relaxations' per-chunk traces (see ``solve_sweep_torch`` and
    ``distilp_torch.obs.convergence.build_search_trace``); the ``conv_*``
    digest lands in ``timings``. The solve is the same as without it; an
    escalated retry re-fills the dict with the final solve's telemetry.

    ``margin_state``: a dict threaded across streaming MoE ticks that turns
    on the margin fast path (the previous tick's decomposition bounds reused
    under drift accounted for on the host, ``margin_bounds_from_state``);
    ``StreamingReplanner`` threads one.

    Returns the assignment minimizing the modeled per-round latency with its
    certificate; raises ``Infeasible`` (a ``RuntimeError``) if no k admits
    a feasible one.
    """
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
            margin_state=margin_state, convergence=convergence,
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
                device=dev, convergence=convergence, **esc_kw,
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
        raise Infeasible("No feasible MILP found for any k.")
    result = _best_to_result(best, sets)
    if plot:
        from .plotter import plot_k_curve

        plot_k_curve(per_k_objs, k_star=result.k)
    return result


class PendingHalda:
    """A ``halda_solve`` in flight: built, uploaded and searching on a
    worker thread. ``collect()`` waits for it and returns the
    ``HALDAResult``; made by :func:`halda_solve_async`."""

    def __init__(self, pending: PendingSweep, sets):
        self._pending = pending
        self._sets = sets

    def collect(self) -> HALDAResult:
        _, best = collect_sweep(self._pending)
        if best is None:
            raise Infeasible("No feasible MILP found for any k.")
        return _best_to_result(best, self._sets)


def halda_solve_async(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    k_candidates: Optional[Iterable[int]] = None,
    mip_gap: Optional[float] = 1e-4,
    kv_bits: str = "8bit",
    moe: Optional[bool] = None,
    warm: Optional[HALDAResult] = None,
    max_rounds: Optional[int] = None,
    beam: Optional[int] = None,
    ipm_iters: Optional[int] = None,
    ipm_warm_iters: Optional[int] = None,
    node_cap: Optional[int] = None,
    load_factors: Optional[Sequence[float]] = None,
    batch_size: int = 1,
    margin_state: Optional[dict] = None,
    lp_backend: str = "auto",
    pdhg_iters: Optional[int] = None,
    pdhg_restart_tol: Optional[float] = None,
    mesh_shards: Optional[int] = None,
    pdhg_dtype: Optional[str] = None,
    convergence: Optional[dict] = None,
    timings: Optional[dict] = None,
    device=None,
) -> PendingHalda:
    """Dispatch a solve and return without waiting for it.

    The instance build, the standard form and the upload run on the calling
    thread; the branch-and-bound search then runs on the port's search
    worker thread, on a CUDA stream of its own, while the caller goes on
    (typically building the next instance). Searches dispatched together
    run one after another, in dispatch order. Redeem it with ``.collect()``, which returns what
    ``halda_solve`` returns (without its certification escalation, as in
    the JAX package) and raises what the search raised. ``device`` as in
    ``halda_solve``: no GPU raises here, at dispatch; there is no fall-back to
    a synchronous CPU solve. A sweep with no structurally feasible k raises
    ``Infeasible`` at dispatch. ``timings`` is filled when ``collect()``
    returns. The margin chain (``margin_state``) works pipelined too: the
    bound reuse is decided at dispatch, the anchor refresh at collect; and
    so does ``convergence``: recorded by the search, decoded into the dict
    by ``collect()``.
    """
    dev = resolve_device(device)
    Ks, sets, coeffs, arrays = _build_instance(
        devs, model, k_candidates, kv_bits, moe, load_factors, batch_size
    )
    pending = solve_sweep_torch(
        arrays, [(k, model.L // k) for k in Ks],
        mip_gap=mip_gap if mip_gap is not None else 1e-4, coeffs=coeffs,
        warm=_warm_to_ilp(warm), max_rounds=max_rounds, beam=beam, ipm_iters=ipm_iters,
        ipm_warm_iters=ipm_warm_iters, node_cap=node_cap, timings=timings,
        lp_backend=lp_backend, pdhg_iters=pdhg_iters, pdhg_restart_tol=pdhg_restart_tol,
        mesh_shards=mesh_shards, pdhg_dtype=pdhg_dtype, device=dev, collect=False,
        margin_state=margin_state, convergence=convergence,
    )
    if not isinstance(pending, PendingSweep):
        # The plain (results, None) of a sweep with no k where W >= M.
        raise Infeasible("No feasible MILP found for any k.")
    return PendingHalda(pending, sets)


def _scenarios_via_batchlayout(built, kWs, mip_gap: float, warm_ilps, *, max_rounds, beam,
                               ipm_iters, ipm_warm_iters, node_cap, lp_backend, pdhg_iters,
                               pdhg_restart_tol, pdhg_dtype=None, timings=None, device=None):
    """The fallback of ``halda_solve_scenarios`` when the static halves
    differ: one packed instance per scenario, each with its own A, searched
    as lanes of one batch (``batchlayout.solve_batch``)."""
    from .batchlayout import pack_instance, solve_batch

    S = len(built)

    def mk(warms_l):
        return [
            pack_instance(
                arrays, kWs, mip_gap=mip_gap, coeffs=coeffs, warm=warms_l[i],
                ipm_iters=ipm_iters, max_rounds=max_rounds, beam=beam, node_cap=node_cap,
                ipm_warm_iters=ipm_warm_iters, lp_backend=lp_backend, pdhg_iters=pdhg_iters,
                pdhg_restart_tol=pdhg_restart_tol, pdhg_dtype=pdhg_dtype,
            )
            for i, (_, _, coeffs, arrays) in enumerate(built)
        ]

    insts = mk(warm_ilps if warm_ilps is not None else [None] * S)
    if any(inst is None for inst in insts):
        return [([None] * len(kWs), None) for _ in range(S)]
    if len({inst.signature for inst in insts}) > 1:
        # Warm hints engaged unevenly across lanes: drop them everywhere
        # (the both-or-cold rule of the shared-static path).
        insts = mk([None] * S)
        if len({inst.signature for inst in insts}) > 1:
            raise ValueError(
                "scenarios do not share a packed shape family (fleet size, k grid, "
                "or model shape differ across scenarios); solve them as separate sweeps"
            )
    if timings is not None:
        timings["scenario_fallback"] = 1.0
        timings["lp_backend"] = insts[0].statics["lp_backend"]
    return solve_batch(insts, timings=timings, device=device)


def halda_solve_scenarios(
    scenarios: Sequence[Sequence[DeviceProfile]],
    model: ModelProfile,
    k_candidates: Optional[Iterable[int]] = None,
    mip_gap: Optional[float] = 1e-4,
    kv_bits: str = "8bit",
    moe: Optional[bool] = None,
    warms: Optional[Sequence[Optional[HALDAResult]]] = None,
    max_rounds: Optional[int] = None,
    beam: Optional[int] = None,
    ipm_iters: Optional[int] = None,
    ipm_warm_iters: Optional[int] = None,
    node_cap: Optional[int] = None,
    load_factors_list: Optional[Sequence[Optional[Sequence[float]]]] = None,
    timings: Optional[dict] = None,
    batch_size: int = 1,
    lp_backend: str = "auto",
    pdhg_iters: Optional[int] = None,
    pdhg_restart_tol: Optional[float] = None,
    pdhg_dtype: Optional[str] = None,
    device=None,
) -> List[HALDAResult]:
    """Solve S what-if variants of one fleet as the lanes of one search.

    Each scenario is the same fleet under different profile drift
    (candidate t_comm futures, per-device expert load factors). Their static
    halves match, so they share one A on ``device`` (None = cuda, raises
    without a GPU; ``'cpu'`` runs the kernels' plain versions), and every
    round runs all S scenarios' rows in one LP call and one rounding and one
    epilogue launch; a MoE batch runs one decomposition ascent over the S
    instances (K7's instance axis).

    Scenarios whose static halves diverge (device speeds or memories, or a
    t_comm/load excursion that moves a row's scaling) fall back to the batch
    layout (``batchlayout``: each scenario its own A, still one search;
    ``timings['scenario_fallback']`` reports it). Only scenarios that do not
    share a packed shape family (fleet size, k grid, model shape) raise
    ValueError.

    ``warms``/``load_factors_list``: optional per-scenario seeds and MoE
    load factors. Warm hints, MoE duals and root iterates engage only when
    every scenario has them. Raises ``RuntimeError`` if a scenario admits no
    feasible placement.
    """
    S = len(scenarios)
    if S == 0:
        return []
    if load_factors_list is not None and len(load_factors_list) != S:
        raise ValueError("load_factors_list must have one entry per scenario")
    if warms is not None and len(warms) != S:
        raise ValueError("warms must have one entry per scenario")
    dev = resolve_device(device)
    built = [
        _build_instance(devs, model, k_candidates, kv_bits, moe,
                        load_factors_list[i] if load_factors_list is not None else None,
                        batch_size)
        for i, devs in enumerate(scenarios)
    ]
    Ks = built[0][0]
    kWs = [(k, model.L // k) for k in Ks]
    gap = mip_gap if mip_gap is not None else 1e-4
    warm_ilps = [_warm_to_ilp(w) for w in warms] if warms is not None else None
    knobs = dict(max_rounds=max_rounds, beam=beam, ipm_iters=ipm_iters,
                 ipm_warm_iters=ipm_warm_iters, node_cap=node_cap, lp_backend=lp_backend,
                 pdhg_iters=pdhg_iters, pdhg_restart_tol=pdhg_restart_tol,
                 pdhg_dtype=pdhg_dtype)
    try:
        outs = solve_sweep_scenarios(
            [arrays for _, _, _, arrays in built], kWs, [coeffs for _, _, coeffs, _ in built],
            mip_gap=gap, warms=warm_ilps, timings=timings, device=dev, **knobs,
        )
    except ValueError:
        # Static halves diverged: the scenarios still share a signature,
        # which is all the batch layout needs.
        outs = _scenarios_via_batchlayout(built, kWs, gap, warm_ilps, timings=timings,
                                          device=dev, **knobs)
    results: List[HALDAResult] = []
    for i, (_, best) in enumerate(outs):
        if best is None:
            raise RuntimeError(f"No feasible MILP found for scenario {i}.")
        results.append(_best_to_result(best, built[i][1]))
    return results


def halda_solve_per_k(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    k_candidates: Optional[Iterable[int]] = None,
    mip_gap: Optional[float] = 1e-4,
    kv_bits: str = "8bit",
    backend: Backend = "torch",
    moe: Optional[bool] = None,
    max_rounds: Optional[int] = None,
    beam: Optional[int] = None,
    ipm_iters: Optional[int] = None,
    ipm_warm_iters: Optional[int] = None,
    node_cap: Optional[int] = None,
    load_factors: Optional[Sequence[float]] = None,
    batch_size: int = 1,
    time_limit: Optional[float] = 3600.0,
    debug: bool = False,
    plot: bool = False,
    timings: Optional[dict] = None,
    lp_backend: str = "auto",
    pdhg_iters: Optional[int] = None,
    pdhg_restart_tol: Optional[float] = None,
    mesh_shards: Optional[int] = None,
    pdhg_dtype: Optional[str] = None,
    device=None,
) -> List[HALDAResult]:
    """A certified optimum for every feasible k.

    ``halda_solve`` answers "which placement is best": losing segment counts
    prune early against the global incumbent and report objectives only.
    This answers "what would each k cost": every k runs under per-k pruning
    (K3's per-k mode) until its own mip-gap certificate closes, and comes
    back as a full ``HALDAResult`` with its assignment, certificate and gap.
    Structurally infeasible k's and those the search proves infeasible are
    left out of the list.

    ``backend='torch'`` solves the whole family in one sweep on ``device``
    (None = cuda, raises without a GPU; ``'cpu'`` runs the kernels' plain
    versions); ``backend='cpu'`` loops the HiGHS oracle over the k grid
    (``time_limit`` seconds each; the search knobs do not apply).
    """
    if backend not in ("torch", "cpu"):
        raise ValueError(f"Unknown backend {backend!r}; expected 'torch' or 'cpu'")
    dev = resolve_device(device) if backend == "torch" else None
    Ks, sets, coeffs, arrays = _build_instance(
        devs, model, k_candidates, kv_bits, moe, load_factors, batch_size
    )
    if backend == "cpu":
        out: List[HALDAResult] = []
        for k in Ks:
            try:
                res = solve_fixed_k_cpu(
                    arrays, k, model.L // k, time_limit=time_limit, mip_gap=mip_gap
                )
            except Infeasible:
                if debug:
                    print(f"  k={k:<4d}  obj=infeasible")
                continue
            if debug:
                print(f"  k={k:<4d}  obj={res.obj_value:.6f}")
            out.append(_best_to_result(res, sets))
        _plot_per_k(out, plot)
        return out
    results, _ = solve_sweep_torch(
        arrays, [(k, model.L // k) for k in Ks],
        mip_gap=mip_gap if mip_gap is not None else 1e-4, coeffs=coeffs,
        max_rounds=max_rounds, beam=beam, ipm_iters=ipm_iters,
        ipm_warm_iters=ipm_warm_iters, node_cap=node_cap, debug=debug, timings=timings,
        lp_backend=lp_backend, pdhg_iters=pdhg_iters, pdhg_restart_tol=pdhg_restart_tol,
        mesh_shards=mesh_shards, pdhg_dtype=pdhg_dtype, device=dev, per_k_optima=True,
    )
    out = [_best_to_result(r, sets) for r in results if r is not None and r.w is not None]
    _plot_per_k(out, plot)
    return out


def _plot_per_k(out: List[HALDAResult], plot: bool) -> None:
    """The k-curve of a per-k sweep, its best k marked (``plot=True``)."""
    if plot and out:
        from .plotter import plot_k_curve

        plot_k_curve([(r.k, r.obj_value) for r in out],
                     k_star=min(out, key=lambda r: r.obj_value).k)
