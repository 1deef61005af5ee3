"""Load-weighted expert routing: skewed expert popularity shapes placement.

The MoE formulation (``solver.moe``) assumes uniform routing: a device that
hosts ``y_i`` of the ``E`` routed experts serves the load share ``y_i / E``.
Real fleets see skewed expert popularity (``ModelProfile.expert_loads``),
and counts alone cannot see it: which experts a device hosts decides how
much load it serves. So, keeping the MILP linear:

1. ``map_experts``: given solved counts ``y`` and a load vector, assign
   expert ids to devices, hottest first, each on the open device where it
   finishes earliest (LPT list scheduling on the per-unit busy coefficient
   ``g_i`` with ``y_i`` slots). The realized per-device load multipliers
   ``l_i = (served load share) / (y_i / E)`` are ``ExpertMapping.factors``.
2. ``build_moe_arrays(load_factors=...)`` re-prices each y-unit of device i
   at its realized load, so the next solve moves counts in response.
3. ``solve_load_aware``: the fixed-point loop (solve uniform, map,
   re-price, re-solve), keeping the iterate whose realized end-to-end
   objective (``realized_objective``: the whole model objective with the
   expert busy priced at the loads the mapped experts carry) is best. Each
   solve certifies its own linearized instance; the realized objective is
   reported beside it.

The port's copy of ``distilp_tpu/solver/routing.py``. ``realized_objective``
prices through ``rounding.price_fixed_assignment`` (the pricing kernel on a
CUDA device). ``solve_load_aware`` selects on it when its solves run on the
card (``backend='torch'``, the default) and on the expert makespan, with no
realized number, when they run on the HiGHS oracle (``backend='cpu'``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..common import DeviceProfile, ModelProfile


def normalize_loads(loads: Optional[Sequence[float]], E: int) -> np.ndarray:
    """Validated mean-1 load vector of length E (uniform when ``loads`` is
    None or sums to zero)."""
    if loads is None:
        return np.ones(E)
    q = np.asarray(list(loads), dtype=np.float64)
    if q.shape != (E,) or not np.all(np.isfinite(q)) or np.any(q < 0):
        raise ValueError(
            f"expert_loads must be {E} finite non-negative entries, got "
            f"shape {q.shape}"
        )
    total = q.sum()
    if total <= 0:
        return np.ones(E)
    return q * (E / total)


@dataclass
class ExpertMapping:
    """Concrete expert -> device assignment of one placement."""

    expert_of_device: List[List[int]]  # device i -> sorted expert ids hosted
    load_share: np.ndarray  # (M,) fraction of the routed load served
    factors: np.ndarray  # (M,) realized per-y-unit load multipliers


def map_experts(
    y: Sequence[int],
    g_per_unit: Sequence[float],
    loads: np.ndarray,
) -> ExpertMapping:
    """Assign expert ids to devices: LPT list scheduling under slot caps.

    ``g_per_unit[i]`` is device i's busy seconds per uniform y-unit (the
    ``MoEArrays.g_raw`` column, any common scale); an expert goes, hottest
    first, to the device with free slots that minimizes ``g_i * (load
    already assigned + this expert's load)``.
    """
    y = [int(v) for v in y]
    M = len(y)
    E = int(loads.shape[0])
    if sum(y) != E:
        raise ValueError(f"sum(y)={sum(y)} != E={E}")
    g = np.asarray(list(g_per_unit), dtype=np.float64)
    if g.shape != (M,):
        raise ValueError("g_per_unit must have one entry per device")
    g = np.where(g > 0, g, np.max(g, initial=1.0))

    order = np.argsort(-loads, kind="stable")
    assigned_load = np.zeros(M)
    slots_left = np.asarray(y, dtype=np.int64).copy()
    expert_of_device: List[List[int]] = [[] for _ in range(M)]
    for e in order:
        open_devs = np.flatnonzero(slots_left > 0)
        finish = g[open_devs] * (assigned_load[open_devs] + loads[e])
        i = int(open_devs[int(np.argmin(finish))])
        expert_of_device[i].append(int(e))
        assigned_load[i] += loads[e]
        slots_left[i] -= 1

    share = assigned_load / E  # loads are mean-1: the total mass is E
    uniform = np.asarray(y, dtype=np.float64) / E
    factors = np.divide(share, uniform, out=np.ones(M), where=uniform > 0)
    for ids in expert_of_device:
        ids.sort()
    return ExpertMapping(expert_of_device=expert_of_device, load_share=share,
                         factors=factors)


def expert_makespan(g_per_unit: Sequence[float], mapping: ExpertMapping) -> float:
    """Realized expert-busy makespan of a mapping: ``max_i g_i * load_i``,
    with ``load_i`` the mean-1 load mass device i serves (``y_i`` under
    uniform routing). The routing-sensitive slice of the objective."""
    g = np.asarray(list(g_per_unit), dtype=np.float64)
    E = float(sum(len(ids) for ids in mapping.expert_of_device))
    return float(np.max(g * (mapping.load_share * E)))


def realized_objective(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    result,
    mapping: ExpertMapping,
    kv_bits: str = "8bit",
    coeffs=None,
    device=None,
) -> float:
    """Exact model objective of ``result``'s placement with every device's
    expert busy priced at the loads its mapped experts carry: the instance
    built at ``load_factors = mapping.factors`` with the solve's
    anti-oscillation floor off (``factor_floor=0``), and the fixed
    ``(k, w, n, y)`` priced by ``price_fixed_assignment`` (dense costs,
    slack penalties and the cycle term included) on ``device`` (None =
    cuda, raises without a GPU; ``'cpu'`` runs the plain version).

    ``coeffs`` (the dense ``HaldaCoeffs`` of the expert-free adjusted
    profile) skips rebuilding what a surrounding loop already built.
    """
    from ..common import kv_bits_to_factor
    from .assemble import assemble
    from .backend_torch import resolve_device
    from .coeffs import assign_sets, build_coeffs
    from .moe import adjust_model, build_moe_arrays
    from .rounding import price_fixed_assignment, rounding_data
    from .standard_form import rounding_arrays_np

    dev = resolve_device(device)
    if coeffs is None:
        coeffs = build_coeffs(
            devs, adjust_model(model), kv_bits_to_factor(kv_bits), assign_sets(devs)
        )
    arrays = assemble(
        coeffs,
        moe=build_moe_arrays(devs, model, load_factors=mapping.factors, factor_floor=0.0),
    )
    rd = rounding_data(rounding_arrays_np(coeffs, arrays.moe), dev)
    lin = float(price_fixed_assignment(
        rd, result.k, model.L // result.k, result.w, result.n, result.y
    ))
    return lin + float(arrays.obj_const)


def solve_load_aware(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    expert_loads: Optional[Sequence[float]] = None,
    iters: int = 2,
    **solve_kwargs,
):
    """Fixed-point loop: solve -> map experts -> re-price -> re-solve.

    Returns ``(result, mapping, realized)`` for the iterate whose realized
    end-to-end objective (``realized_objective``) is best. Later iterates
    warm-start from the previous placement; one whose warm solve misses its
    certificate is solved again cold. With uniform loads (``expert_loads``
    None and none on the profile) this is one ``halda_solve`` and a trivial
    mapping.

    ``realized`` is ``None`` when the solves run on the HiGHS oracle
    (``backend='cpu'``): the iterates are then compared on the expert-busy
    makespan, a different metric in other units, which is why it is not
    returned in the realized slot. The default backend ``'torch'`` selects
    end to end, pricing on the solves' ``device``.
    """
    from ..common import kv_bits_to_factor
    from . import api
    from .coeffs import assign_sets, build_coeffs
    from .moe import adjust_model, build_moe_arrays

    for managed in ("moe", "warm", "load_factors"):
        if managed in solve_kwargs:
            raise TypeError(
                f"solve_load_aware manages {managed!r} itself; pass it "
                f"through halda_solve directly if you need manual control"
            )
    if solve_kwargs.get("batch_size", 1) != 1:
        raise ValueError(
            "solve_load_aware is MoE-only and batch_size pricing is "
            "dense-only; the load-aware loop always prices at batch 1"
        )

    loads = normalize_loads(
        expert_loads if expert_loads is not None else model.expert_loads,
        model.n_routed_experts,
    )
    uniform = bool(np.allclose(loads, 1.0))

    # Unweighted busy coefficients: the common metric every iterate's
    # mapping is built with. The dense coefficient block does not depend on
    # the factors: build it once for every realized re-pricing.
    g_base = build_moe_arrays(devs, model).g_raw
    kv_bits = solve_kwargs.get("kv_bits", "8bit")
    dense_coeffs = build_coeffs(
        devs, adjust_model(model), kv_bits_to_factor(kv_bits), assign_sets(devs)
    )
    on_card = solve_kwargs.get("backend", "torch") == "torch"  # halda_solve's default

    factors = None
    best = None
    prev = None
    rounds = 1 if uniform else max(1, int(iters))
    for _ in range(rounds):
        result = api.halda_solve(
            devs, model, moe=True, load_factors=factors, warm=prev, **solve_kwargs
        )
        if prev is not None and not result.certified:
            # The warm solve certifies against the bound at the previous
            # iterate's duals, priced under other factors; a large factor
            # swing can leave it too loose: solve again cold.
            result = api.halda_solve(
                devs, model, moe=True, load_factors=factors, **solve_kwargs
            )
        mapping = map_experts(result.y, g_base, loads)
        if on_card:
            realized = realized_objective(
                devs, model, result, mapping, kv_bits=kv_bits, coeffs=dense_coeffs,
                device=solve_kwargs.get("device"),
            )
            metric = realized
        else:
            realized = None
            metric = expert_makespan(g_base, mapping)
        if best is None or metric < best[3]:
            best = (result, mapping, realized, metric)
        if uniform:
            break
        factors = mapping.factors
        prev = result
    return best[:3]
