"""Public digital-twin API of the port: evaluate, stress-test and rank
placements (``distilp_tpu/twin/api.py``, same signatures plus ``device``).

``evaluate_placement``  — deterministic simulated execution (host numpy),
with the per-device breakdown and the HALDA-objective cross-check.
``robustness_report``   — seeded Monte-Carlo: latency quantiles under device
drift, feasibility-violation probability, worst-device sensitivity ranking;
one launch of kernel K8 per report on ``device`` (None = cuda, raising
without a GPU; 'cpu' runs the plain version).
``rank_agreement``      — does the twin order candidate placements the same
way the solver objective does?
``twin_p95_score``      — the risk-aware scoring primitive.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..common import DeviceProfile, ModelProfile
from ..solver.result import HALDAResult
from .model import (
    TwinArrays,
    build_twin_arrays,
    placement_applicable,
    placement_vectors,
    simulate_placement,
)
from .engine import run_monte_carlo
from .report import DeviceSensitivity, RobustnessReport, TwinEvaluation

# Feasibility-violation weight in the risk score: a placement with ANY
# observed violation probability must lose to every violation-free one at
# any latency scale this solver produces (objectives are O(10) seconds) —
# so the penalty has a fixed step at p > 0 plus a graded term that still
# orders violating candidates among themselves.
VIOLATION_PENALTY_S = 1e3


def evaluate_placement(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    result: HALDAResult,
    kv_bits: str = "8bit",
    moe: Optional[bool] = None,
    load_factors: Optional[Sequence[float]] = None,
    batch_size: int = 1,
    cross_check: bool = True,
) -> TwinEvaluation:
    """Deterministically execute ``result`` on the fleet's digital twin.

    ``kv_bits``/``moe``/``batch_size``/``load_factors`` must match what the
    placement was solved with — they define the coefficient vocabulary the
    twin prices against (same builders as the solver). ``cross_check``
    fills the report's objective/rel_err fields from ``result.obj_value``.
    """
    arrays = build_twin_arrays(
        devs, model, kv_bits=kv_bits, moe=moe,
        load_factors=load_factors, batch_size=batch_size,
    )
    return simulate_placement(
        arrays,
        result.w,
        result.n,
        y=result.y,
        k=result.k,
        objective=result.obj_value if cross_check else None,
    )


def robustness_report(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    result: HALDAResult,
    samples: int = 1024,
    seed: int = 0,
    kv_bits: str = "8bit",
    moe: Optional[bool] = None,
    load_factors: Optional[Sequence[float]] = None,
    batch_size: int = 1,
    sigma_compute: float = 0.08,
    sigma_comm: float = 0.15,
    sigma_disk: float = 0.10,
    sigma_mem: float = 0.0,
    dropout_p: float = 0.0,
    dropout_slowdown: float = 8.0,
    degrade: float = 1.25,
    arrays: Optional[TwinArrays] = None,
    device=None,
) -> RobustnessReport:
    """Monte-Carlo robustness report for one placement (one K8 launch on
    ``device``).

    ``arrays`` lets repeated callers (scoring many candidates per tick)
    reuse one fleet build. Deterministic for a fixed seed.
    """
    if arrays is None:
        arrays = build_twin_arrays(
            devs, model, kv_bits=kv_bits, moe=moe,
            load_factors=load_factors, batch_size=batch_size,
        )
    vec = placement_vectors(arrays, result.w, result.n, y=result.y, k=result.k)
    out = run_monte_carlo(
        vec,
        samples=samples,
        seed=seed,
        sigma_compute=sigma_compute,
        sigma_comm=sigma_comm,
        sigma_disk=sigma_disk,
        sigma_mem=sigma_mem,
        dropout_p=dropout_p,
        dropout_slowdown=dropout_slowdown,
        degrade=degrade,
        device=device,
    )
    lat = np.asarray(out["latencies"], dtype=float)
    base = out["base_latency"]
    deltas = np.maximum(0.0, np.asarray(out["sens_latencies"], dtype=float) - base)
    total = float(deltas.sum())
    order = np.argsort(-deltas, kind="stable")
    sensitivity = [
        DeviceSensitivity(
            name=devs[int(j)].name,
            delta_s=float(deltas[int(j)]),
            share=float(deltas[int(j)] / total) if total > 0 else 0.0,
        )
        for j in order
    ]
    return RobustnessReport(
        samples=int(samples),
        seed=int(seed),
        sigma_compute=sigma_compute,
        sigma_comm=sigma_comm,
        sigma_disk=sigma_disk,
        sigma_mem=sigma_mem,
        dropout_p=dropout_p,
        dropout_slowdown=dropout_slowdown,
        degrade=degrade,
        base_latency_s=base,
        mean_s=float(lat.mean()),
        p50_s=float(np.percentile(lat, 50)),
        p95_s=float(np.percentile(lat, 95)),
        p99_s=float(np.percentile(lat, 99)),
        worst_s=float(lat.max()),
        p_violation=float(np.asarray(out["violations"]).mean()),
        sensitivity=sensitivity,
    )


def rank_agreement(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    results: Sequence[HALDAResult],
    kv_bits: str = "8bit",
    moe: Optional[bool] = None,
    batch_size: int = 1,
    tie_tol: float = 1e-9,
) -> Dict[str, object]:
    """Twin-vs-objective ranking check over candidate placements.

    Evaluates each candidate's unperturbed twin latency (float64 host
    path) and compares the induced order against the solver objectives:
    ``pairwise_inversions`` counts candidate pairs the two orders disagree
    on (pairs whose objectives differ by less than ``tie_tol`` are ties and
    cannot invert), ``spearman`` is the rank correlation. The acceptance
    bar on the golden fixtures is zero inversions.
    """
    if len(results) < 2:
        raise ValueError("rank agreement needs at least two candidate placements")
    arrays = build_twin_arrays(devs, model, kv_bits=kv_bits, moe=moe, batch_size=batch_size)
    twin = np.array(
        [
            simulate_placement(arrays, r.w, r.n, y=r.y, k=r.k).latency_s
            for r in results
        ]
    )
    obj = np.array([r.obj_value for r in results])
    inversions = 0
    pairs = 0
    for i in range(len(results)):
        for j in range(i + 1, len(results)):
            if abs(obj[i] - obj[j]) <= tie_tol:
                continue
            pairs += 1
            if (obj[i] - obj[j]) * (twin[i] - twin[j]) < 0:
                inversions += 1
    return {
        "pairwise_inversions": inversions,
        "comparable_pairs": pairs,
        "spearman": _spearman(obj, twin),
        "twin_latencies": [float(x) for x in twin],
        "objectives": [float(x) for x in obj],
        "ks": [int(r.k) for r in results],
    }


def _spearman(a: np.ndarray, b: np.ndarray) -> float:
    """Spearman rank correlation (average ranks for ties; no scipy needed)."""

    def _ranks(x: np.ndarray) -> np.ndarray:
        order = np.argsort(x, kind="stable")
        ranks = np.empty(len(x), dtype=float)
        ranks[order] = np.arange(len(x), dtype=float)
        # Average tied ranks so exact-duplicate objectives don't skew rho.
        for v in np.unique(x):
            mask = x == v
            if mask.sum() > 1:
                ranks[mask] = ranks[mask].mean()
        return ranks

    ra, rb = _ranks(np.asarray(a, dtype=float)), _ranks(np.asarray(b, dtype=float))
    va = ra - ra.mean()
    vb = rb - rb.mean()
    denom = float(np.sqrt((va * va).sum() * (vb * vb).sum()))
    if denom == 0.0:
        return 1.0
    return float((va * vb).sum() / denom)


def twin_p95_score(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    result: HALDAResult,
    samples: int = 256,
    seed: int = 0,
    kv_bits: str = "8bit",
    moe: Optional[bool] = None,
    arrays: Optional[TwinArrays] = None,
    **mc_kwargs,
) -> Dict[str, float]:
    """Risk score of one placement: twin p95 latency + violation penalty.

    Risk-aware serving minimizes this over candidates — lower is better; a
    placement with any feasibility-violation probability is pushed behind
    every violation-free one. Returns ``{"score", "p95_s", "p_violation",
    "base_latency_s"}``; ``mc_kwargs`` (``device`` among them) go to
    :func:`robustness_report`.
    """
    rep = robustness_report(
        devs, model, result, samples=samples, seed=seed,
        kv_bits=kv_bits, moe=moe, arrays=arrays, **mc_kwargs,
    )
    penalty = (
        VIOLATION_PENALTY_S * (1.0 + rep.p_violation)
        if rep.p_violation > 0
        else 0.0
    )
    return {
        "score": rep.p95_s + penalty,
        "p95_s": rep.p95_s,
        "p_violation": rep.p_violation,
        "base_latency_s": rep.base_latency_s,
    }


def applicable_candidates(
    arrays: TwinArrays,
    candidates: Sequence[Optional[HALDAResult]],
) -> List[HALDAResult]:
    """Filter cached placements down to ones this fleet can execute."""
    out: List[HALDAResult] = []
    for c in candidates:
        if c is None:
            continue
        if placement_applicable(arrays, c.w, c.n, y=c.y, k=c.k):
            out.append(c)
    return out
