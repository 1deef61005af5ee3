"""Digital-twin pipeline execution model of a HALDA placement.

The port's copy of the JAX package's host-side twin model (numpy, built on
the port's own ``solver.coeffs``/``solver.moe``): it gives arrays equal bit
for bit to the reference's, and it is the conformance oracle of the
Monte-Carlo kernel (``twin.engine``).

Deterministically simulates executing a placement ``(k, w, n[, y])`` over a
fleet of :class:`DeviceProfile` s: per-segment compute from the same
alpha/beta/xi coefficient vocabulary the solver prices with
(``solver.coeffs``), inter-device transfer from ``t_comm`` (whose measured
link shape is ``comm_latency + payload/comm_bandwidth``), GPU-offload split
from ``n``, memory-overflow disk streaming from the capacity rows, and the
pipeline's steady-state cycle/prefetch overlap.

The simulation reproduces the MILP's own physics on purpose: for a fixed
integer assignment the optimal stall is ``z_i = F_i / 2`` (it equalizes the
cycle and prefetch bounds), the optimal spill is the minimal integer slack
covering each memory deficit, and the steady-state cycle time is
``C = max_i (B_i + F_i/2)`` — so the twin's unperturbed latency must equal
the HALDA objective of the same placement. That equality is the
conformance contract cross-checked on the golden fixtures
(``tests/test_torch_twin.py``); everything the Monte-Carlo engine perturbs
(``twin.engine``) starts from these arrays.

Host-side numpy only (same layering as ``solver.coeffs``): the arrays are
O(M) and built once per placement; the Monte-Carlo sampling lives in
``twin.engine``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from ..common import DeviceProfile, ModelProfile, kv_bits_to_factor
from ..solver.assemble import INACTIVE_RHS  # the MILP's own inactive-row RHS
from ..solver.coeffs import HaldaCoeffs, build_coeffs
from .report import DeviceTwinRow, TwinEvaluation


@dataclass
class TwinArrays:
    """Everything one fleet+model instance's twin needs, as dense arrays.

    Placement-independent: one build serves every candidate placement of
    the same fleet (the risk-aware scheduler scores many placements against
    one build). All arrays are (M,) float64 unless noted.
    """

    M: int
    L: int
    bp: float  # resident bytes per layer (b')
    moe: bool
    E: int  # routed experts (0 in dense mode)
    names: List[str]
    a: np.ndarray  # CPU seconds per layer
    b_gpu: np.ndarray  # accelerator-minus-CPU delta seconds per layer
    g_raw: np.ndarray  # MoE seconds per y-unit, times k (zeros in dense)
    xi: np.ndarray  # host<->accelerator round trip seconds
    t_comm: np.ndarray  # per-round link seconds
    pen_set: np.ndarray  # disk penalty sec per RAM-spilled layer (by set)
    pen_vram: np.ndarray  # disk penalty sec per VRAM-spilled layer
    prefetch_coef: np.ndarray  # b'/s_disk: prefetch seconds per hosted layer
    ram_coef_n: np.ndarray  # b' where the RAM row subtracts n, else 0
    eb_ram: np.ndarray  # resident expert bytes per y in the primary pool
    ram_rhs: np.ndarray  # RAM capacity row RHS (INACTIVE_RHS when absent)
    eb_vram: np.ndarray
    cuda_rhs: np.ndarray
    eb_metal: np.ndarray
    metal_rhs: np.ndarray
    has_gpu: np.ndarray  # bool
    kappa: float  # head I/O + tail-deficit objective constant


def build_twin_arrays(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    kv_bits: str = "8bit",
    moe: Optional[bool] = None,
    load_factors: Optional[Sequence[float]] = None,
    batch_size: int = 1,
) -> TwinArrays:
    """Assemble the twin's arrays with the solver's own coefficient builders.

    Mirrors ``solver.api._build_instance``: MoE placements price their
    dense half on the expert-free adjusted profile and carry the expert
    block (``g_raw``/``eb_*``) separately, so the twin and the MILP read
    the same numbers from the same code path.
    """
    from ..solver.moe import adjust_model, build_moe_arrays, resolve_moe

    use_moe = resolve_moe(model, moe)
    kv_factor = kv_bits_to_factor(kv_bits)
    if use_moe:
        coeffs = build_coeffs(devs, adjust_model(model), kv_factor, batch_size=batch_size)
        marr = build_moe_arrays(devs, model, load_factors=load_factors)
    else:
        coeffs = build_coeffs(devs, model, kv_factor, batch_size=batch_size)
        marr = None
    return _arrays_from_coeffs(coeffs, marr, [d.name for d in devs])


def _arrays_from_coeffs(coeffs: HaldaCoeffs, marr, names: List[str]) -> TwinArrays:
    M = coeffs.M
    pen_by_set = {1: coeffs.pen_m1, 2: coeffs.pen_m2, 3: coeffs.pen_m3}
    pen_set = np.zeros(M)
    for i in range(M):
        pen_set[i] = pen_by_set[int(coeffs.set_id[i])][i]

    def _rhs(active: np.ndarray, vals: np.ndarray) -> np.ndarray:
        out = np.where(active, vals, INACTIVE_RHS)
        return np.where(np.isfinite(out), out, INACTIVE_RHS)

    zeros = np.zeros(M)
    return TwinArrays(
        M=M,
        L=coeffs.L,
        bp=float(coeffs.bprime),
        moe=marr is not None,
        E=int(marr.E) if marr is not None else 0,
        names=list(names),
        a=np.asarray(coeffs.a, dtype=float),
        b_gpu=np.asarray(coeffs.b_gpu, dtype=float),
        g_raw=np.asarray(marr.g_raw, dtype=float) if marr is not None else zeros,
        xi=np.asarray(coeffs.xi, dtype=float),
        t_comm=np.asarray(coeffs.t_comm, dtype=float),
        pen_set=pen_set,
        pen_vram=np.asarray(coeffs.pen_vram, dtype=float),
        prefetch_coef=coeffs.bprime / np.asarray(coeffs.s_disk, dtype=float),
        ram_coef_n=np.where(coeffs.ram_minus_n, coeffs.bprime, 0.0),
        eb_ram=np.asarray(marr.eb_ram, dtype=float) if marr is not None else zeros,
        ram_rhs=_rhs(np.ones(M, dtype=bool), np.asarray(coeffs.ram_rhs, dtype=float)),
        eb_vram=np.asarray(marr.eb_vram, dtype=float) if marr is not None else zeros,
        cuda_rhs=_rhs(coeffs.cuda_row, np.asarray(coeffs.cuda_rhs, dtype=float)),
        eb_metal=np.asarray(marr.eb_metal, dtype=float) if marr is not None else zeros,
        metal_rhs=_rhs(coeffs.metal_row, np.asarray(coeffs.metal_rhs, dtype=float)),
        has_gpu=np.asarray(coeffs.has_gpu, dtype=bool),
        kappa=float(coeffs.kappa),
    )


def placement_applicable(arrays: TwinArrays, w, n, y=None, k: Optional[int] = None) -> bool:
    """Whether a (possibly cached/stale) placement can execute on this fleet.

    Structural checks only — the risk-aware scheduler uses this to filter
    warm-pool candidates before pricing them: right device count, window
    sums matching L, the offload count within the window, no accelerator
    layers on accelerator-free devices, and (MoE) a full expert cover.
    """
    w = np.asarray(w)
    n = np.asarray(n)
    if w.shape != (arrays.M,) or n.shape != (arrays.M,):
        return False
    if np.any(w < 1) or np.any(n < 0) or np.any(n > w):
        return False
    if k is not None and (k <= 0 or int(w.sum()) * int(k) != arrays.L):
        return False
    if np.any((n > 0) & ~arrays.has_gpu):
        return False
    if arrays.moe:
        if y is None:
            return False
        y = np.asarray(y)
        if y.shape != (arrays.M,) or np.any(y < 0) or int(y.sum()) != arrays.E:
            return False
    elif y is not None and np.any(np.asarray(y) != 0):
        return False
    return True


@dataclass
class PlacementVectors:
    """One placement reduced to the per-device vectors the engine perturbs.

    Precomputing these on the host keeps the kernel's signature
    placement-shape-free: every candidate of one fleet goes through the same
    launch (the row axis is the only batch dimension).
    """

    compute0: np.ndarray  # a·w + b·n + (g/k)·y seconds at nominal speed
    comm0: np.ndarray  # t_comm
    off0: np.ndarray  # xi
    prefetch0: np.ndarray  # F_i at nominal disk speed
    pen_set: np.ndarray
    pen_vram: np.ndarray
    ram_lhs0: np.ndarray  # resident bytes charged to the RAM row
    ram_rhs: np.ndarray
    cuda_lhs0: np.ndarray
    cuda_rhs: np.ndarray
    metal_lhs0: np.ndarray
    metal_rhs: np.ndarray
    s_cap: np.ndarray  # max RAM-spill layers the MILP's slack allows
    t_cap: np.ndarray  # max VRAM-spill layers
    bp: float
    k: int
    kappa: float


def placement_vectors(
    arrays: TwinArrays, w, n, y=None, k: int = 1
) -> PlacementVectors:
    """Reduce one placement to the engine's per-device vectors."""
    w = np.asarray(w, dtype=float)
    n = np.asarray(n, dtype=float)
    if arrays.moe:
        if y is None:
            raise ValueError("MoE twin needs the expert assignment y")
        y = np.asarray(y, dtype=float)
    else:
        y = np.zeros(arrays.M)
    W = arrays.L // int(k)
    compute0 = arrays.a * w + arrays.b_gpu * n + (arrays.g_raw / float(k)) * y
    # Slack caps follow the MILP bounds: W layers in dense mode; in MoE mode
    # a device cannot stream more layers than it hosts (s <= w, t <= n).
    s_cap = np.minimum(w, W) if arrays.moe else np.full(arrays.M, float(W))
    t_cap = np.minimum(n, W) if arrays.moe else np.where(arrays.has_gpu, float(W), 0.0)
    return PlacementVectors(
        compute0=compute0,
        comm0=arrays.t_comm.copy(),
        off0=arrays.xi.copy(),
        prefetch0=arrays.prefetch_coef * w,
        pen_set=arrays.pen_set.copy(),
        pen_vram=arrays.pen_vram.copy(),
        ram_lhs0=arrays.bp * w - arrays.ram_coef_n * n + arrays.eb_ram * y,
        ram_rhs=arrays.ram_rhs.copy(),
        cuda_lhs0=arrays.bp * n + arrays.eb_vram * y,
        cuda_rhs=arrays.cuda_rhs.copy(),
        metal_lhs0=arrays.bp * n + arrays.eb_metal * y,
        metal_rhs=arrays.metal_rhs.copy(),
        s_cap=s_cap,
        t_cap=t_cap,
        bp=arrays.bp,
        k=int(k),
        kappa=arrays.kappa,
    )


def simulate_placement(
    arrays: TwinArrays,
    w: Sequence[int],
    n: Sequence[int],
    y: Optional[Sequence[int]] = None,
    k: int = 1,
    objective: Optional[float] = None,
) -> TwinEvaluation:
    """One deterministic pipeline execution (float64, host numpy).

    This is the engine's conformance oracle AND the user-facing breakdown:
    per-device busy times, spill layers, the cycle bound and the predicted
    per-token latency. ``objective`` (the solver's value for the same
    placement) fills the cross-check fields.
    """
    vec = placement_vectors(arrays, w, n, y=y, k=k)
    M = arrays.M

    ram_deficit = np.maximum(0.0, vec.ram_lhs0 - vec.ram_rhs)
    s_need = np.maximum(0.0, np.ceil(ram_deficit / vec.bp - 1e-12))
    vram_deficit = np.maximum(
        np.maximum(0.0, vec.cuda_lhs0 - vec.cuda_rhs),
        np.maximum(0.0, vec.metal_lhs0 - vec.metal_rhs),
    )
    t_need = np.maximum(0.0, np.ceil(vram_deficit / vec.bp - 1e-12))
    feas = (s_need <= vec.s_cap + 1e-9) & (t_need <= vec.t_cap + 1e-9)
    s_used = np.minimum(s_need, vec.s_cap)
    t_used = np.minimum(t_need, vec.t_cap)

    # + 0.0 normalizes the -0.0 that np.maximum(0.0, -0.0) may hand back.
    disk_s = vec.pen_set * s_used + vec.pen_vram * t_used + 0.0
    busy = vec.compute0 + disk_s + vec.off0 + vec.comm0
    cycle_terms = busy + 0.5 * vec.prefetch0
    C = float(cycle_terms.max())
    bottleneck = int(np.argmax(cycle_terms))
    latency = (
        float((vec.compute0 + disk_s).sum())
        + (vec.k - 1) * C
        + float(vec.comm0.sum() + vec.off0.sum())
        + vec.kappa
    )

    y_list = list(np.asarray(y, dtype=int)) if (arrays.moe and y is not None) else None
    rows = [
        DeviceTwinRow(
            name=arrays.names[i],
            w=int(w[i]),
            n=int(n[i]),
            y=int(y_list[i]) if y_list is not None else None,
            busy_s=float(busy[i]),
            compute_s=float(vec.compute0[i]),
            comm_s=float(vec.comm0[i]),
            offload_s=float(vec.off0[i]),
            disk_s=float(disk_s[i]),
            prefetch_s=float(vec.prefetch0[i]),
            spill_layers=int(s_used[i]),
            vram_spill_layers=int(t_used[i]),
            feasible=bool(feas[i]),
        )
        for i in range(M)
    ]
    rel_err = None
    if objective is not None:
        rel_err = abs(latency - objective) / max(1e-12, abs(objective))
    return TwinEvaluation(
        k=int(k),
        W=arrays.L // int(k),
        latency_s=latency,
        cycle_s=C,
        bottleneck=arrays.names[bottleneck],
        feasible=bool(feas.all()),
        objective_s=objective,
        rel_err=rel_err,
        devices=rows,
    )
