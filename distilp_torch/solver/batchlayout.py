"""Multi-instance batch layout: N heterogeneous HALDA instances, one search.

``solve_sweep_torch`` searches one instance; ``solve_sweep_scenarios``
searches S futures of one fleet, which share its A. This module packs
instances that each keep their OWN static half (A, boxes, row scaling,
integer mask), so unrelated fleets (different profiles, different warm
state) search side by side as the lanes of one batched search (the
reference's ``_solve_batched``, B12) as long as their shape signature
matches. Each round runs every lane's beam rows through one K1 call (its
per-element-A route, over the union of the lanes' sparsity patterns), one
K2 and one K3 launch.

Mixed device counts inside a bucket ride *phantom padding*
(:func:`pad_instance`): a dense instance with ``M_real`` devices is extended
to the bucket's ``M_pad`` with zero-cost phantom devices whose layer count
is pinned to the ``[0, 0]`` box. Every phantom coefficient is zero and
every phantom capacity row inactive, so the padded MILP's feasible set is
the real one's times {0}^pad: objectives, certificates and duals carry over
exactly. The rounding learns about phantoms through ``w_active`` (0 marks a
phantom; the per-device rounding box becomes ``[w_active, W w_active]``).

Padding is dense-only: the MoE Lagrangian decomposition enumerates
``w in [1, w_max]`` per device and has no zero-width device, so MoE
instances bucket by exact M instead.

A lane's static half is uploaded once and then lives on the device behind
:func:`lane_static_to_device`'s content-addressed cache; a batch stacks its
lanes' A matrices from the cached device copies (a device-side copy, not a
host upload). A lane batch on the PDHG engine (M >= 128) runs K5's
per-element entry on the union of the lanes' sparse patterns, each lane's
values gathered once per batch.

Ported from ``distilp_tpu/solver/batchlayout.py``; nothing here imports JAX.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..ops.pdhg import DEFAULT_RESTART_TOL
from .assemble import INACTIVE_RHS, MilpArrays, assemble
from .backend_torch import (
    LaneInput,
    _decode_sweep,
    _prepare,
    _search,
    _search_params,
    lane_input,
    pack_static,
)
from .coeffs import HaldaCoeffs
from .result import ILPResult
from .standard_form import DECOMP_STEPS_COLD, DECOMP_STEPS_WARM
from ..obs.compile_ledger import instrument as _instrument

__all__ = [
    "PACKED_STATIC_ARGS",
    "PackedInstance",
    "clear_lane_static_cache",
    "lane_static_to_device",
    "pad_instance",
    "pack_instance",
    "solve_batch",
    "unpad_result",
]

# The search-shape names of a packed instance (the reference's
# _PACKED_STATIC_ARGS less its constant mesh_shards and diag): instances
# search together iff these are equal.
PACKED_STATIC_ARGS = (
    "M", "n_k", "m", "nf", "cap", "ipm_iters", "max_rounds", "beam", "moe",
    "has_warm", "w_max", "e_max", "decomp_steps", "has_duals", "per_k",
    "has_margin", "ipm_warm_iters", "has_root_warm", "lp_backend",
    "pdhg_restart_tol", "pdhg_dtype",
)

# Per-lane device cache of static halves, keyed by (device, packed bytes).
# Eviction at the cap is always correct: the evicted lane pays one re-upload.
_LANE_STATIC_CACHE: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_LANE_STATIC_CAP = 512
_LANE_STATIC_LOCK = threading.Lock()


def lane_static_to_device(vec: np.ndarray, device) -> Tuple[torch.Tensor, bool]:
    """(device copy of one lane's packed static half, uploaded-this-call),
    content-addressed and LRU-bounded."""
    key = (str(torch.device(device)), vec.tobytes())
    with _LANE_STATIC_LOCK:
        dev = _LANE_STATIC_CACHE.get(key)
        if dev is not None:
            _LANE_STATIC_CACHE.move_to_end(key)
            return dev, False
    dev = torch.as_tensor(vec, device=device)
    with _LANE_STATIC_LOCK:
        _LANE_STATIC_CACHE[key] = dev
        while len(_LANE_STATIC_CACHE) > _LANE_STATIC_CAP:
            _LANE_STATIC_CACHE.popitem(last=False)
    return dev, True


def clear_lane_static_cache() -> None:
    """Drop cached per-lane static device copies (tests; device teardown)."""
    with _LANE_STATIC_LOCK:
        _LANE_STATIC_CACHE.clear()


def _ext(vec: np.ndarray, pad: int, fill: float = 0.0) -> np.ndarray:
    """``vec`` extended by ``pad`` trailing ``fill`` entries (dtype kept)."""
    out = np.full(len(vec) + pad, fill, dtype=np.asarray(vec).dtype)
    out[: len(vec)] = vec
    return out


def pad_instance(
    coeffs: HaldaCoeffs, arrays: MilpArrays, M_pad: int
) -> Tuple[HaldaCoeffs, MilpArrays]:
    """Extend a dense instance to ``M_pad`` devices with zero-cost phantoms.

    The phantom profile: no compute, no memory (every capacity row
    inactive), no accelerator, no disk penalty. After assembly the phantom
    boxes are pinned: ``w in [0, 0]`` (the global ``w >= 1`` floor dropped
    for phantoms only), its set-3 slack and its ``z`` overflow ``[0, 0]``.
    The sum-of-w equality then puts every layer on a real device and each
    phantom's rows are slack: the optimum, its certificate and the per-k
    objectives are exactly the unpadded instance's. The returned coeffs
    carry ``w_active`` (1 real, 0 phantom) for the rounding."""
    M = coeffs.M
    if M_pad < M:
        raise ValueError(f"cannot pad M={M} down to {M_pad}")
    if arrays.moe is not None:
        raise ValueError(
            "phantom padding is dense-only: the MoE Lagrangian decomposition "
            "enumerates w in [1, w_max] per device and has no zero-width "
            "device; bucket MoE instances by exact M instead"
        )
    pad = M_pad - M
    if pad == 0:
        return coeffs, arrays
    false_pad = np.zeros(pad, dtype=bool)
    coeffs_p = replace(
        coeffs,
        M=M_pad,
        a=_ext(coeffs.a, pad),
        b_gpu=_ext(coeffs.b_gpu, pad),
        xi=_ext(coeffs.xi, pad),
        t_comm=_ext(coeffs.t_comm, pad),
        # A phantom never streams: its disk is "infinitely fast", so the
        # prefetch row's b'/s_disk term vanishes instead of dividing by 0.
        s_disk=_ext(coeffs.s_disk, pad, INACTIVE_RHS),
        pen_m1=_ext(coeffs.pen_m1, pad),
        pen_m2=_ext(coeffs.pen_m2, pad),
        pen_m3=_ext(coeffs.pen_m3, pad),
        pen_vram=_ext(coeffs.pen_vram, pad),
        set_id=_ext(coeffs.set_id, pad, 3),
        has_gpu=np.concatenate([coeffs.has_gpu, false_pad]),
        ram_rhs=_ext(coeffs.ram_rhs, pad, INACTIVE_RHS),
        ram_minus_n=np.concatenate([coeffs.ram_minus_n, false_pad]),
        cuda_row=np.concatenate([coeffs.cuda_row, false_pad]),
        cuda_rhs=_ext(coeffs.cuda_rhs, pad),
        metal_row=np.concatenate([coeffs.metal_row, false_pad]),
        metal_rhs=_ext(coeffs.metal_rhs, pad),
    )
    arrays_p = assemble(coeffs_p)
    lay = arrays_p.layout
    for i in range(M, M_pad):
        arrays_p.lb[lay.w(i)] = 0.0  # drop the w >= 1 floor
        arrays_p.ub_scale[lay.w(i)] = 0.0  # w <= 0: pinned box
        arrays_p.ub_scale[lay.s3(i)] = 0.0  # no free zero-cost slack
        arrays_p.ub_const[lay.z(i)] = 0.0  # no degenerate overflow column
        arrays_p.ub_scale[lay.z(i)] = 0.0
    coeffs_p.w_active = np.concatenate([np.ones(M), np.zeros(pad)])
    return coeffs_p, arrays_p


@dataclass
class PackedInstance:
    """One instance packed for a batch: its static half (the cache key and
    the lane's A), its host half (:class:`LaneInput`), the search-shape
    statics, and what the decode needs."""

    static_np: np.ndarray  # float32 drift-invariant half (pack_static)
    lane: LaneInput
    statics: dict  # PACKED_STATIC_ARGS name -> value
    M_real: int
    M_pad: int
    feasible: List[Tuple[int, int]]
    kWs: List[Tuple[int, int]]
    mip_gap: float
    nf: int
    m: int
    stats: Optional[dict] = None

    @property
    def signature(self) -> tuple:
        """Bucket identity: instances search as lanes of one batch iff their
        signatures are equal (the statics plus the static half's length)."""
        return tuple(self.statics[a] for a in PACKED_STATIC_ARGS) + (
            int(self.static_np.size),
        )


def _pad_warm(warm: Optional[ILPResult], pad: int) -> Optional[ILPResult]:
    """Zero-extend a warm hint's assignment to the padded width (phantoms
    take w = n = y = 0, exactly the padded optimum's shape)."""
    if warm is None or pad == 0 or warm.w is None:
        return warm
    zeros = [0] * pad
    return warm.model_copy(
        update={
            "w": list(warm.w) + zeros,
            "n": list(warm.n) + zeros if warm.n is not None else None,
            "y": list(warm.y) + zeros if warm.y is not None else None,
        }
    )


def pack_instance(
    arrays: MilpArrays,
    kWs: Sequence[Tuple[int, int]],
    mip_gap: float = 1e-4,
    coeffs: Optional[HaldaCoeffs] = None,
    warm: Optional[ILPResult] = None,
    M_pad: Optional[int] = None,
    ipm_iters: Optional[int] = None,
    max_rounds: Optional[int] = None,
    beam: Optional[int] = None,
    node_cap: Optional[int] = None,
    ipm_warm_iters: Optional[int] = None,
    lp_backend: Optional[str] = None,
    pdhg_iters: Optional[int] = None,
    pdhg_restart_tol: Optional[float] = None,
    pdhg_dtype: Optional[str] = None,
    margin_state: Optional[dict] = None,
    per_k_optima: bool = False,
    stats: Optional[dict] = None,
) -> Optional[PackedInstance]:
    """Pack one instance for a batch: ``solve_sweep_torch``'s host half
    (feasibility filter, standard form, search parameters, warm, duals and
    margin bounds) without the upload. ``M_pad`` pads a dense instance to a
    bucket boundary (:func:`pad_instance`); feasibility is judged against
    the real device count. Returns None when no k is structurally
    feasible."""
    if coeffs is None:
        raise ValueError("pack_instance requires the HaldaCoeffs used for assembly")
    M_real = arrays.layout.M
    feasible = [(k, W) for (k, W) in kWs if W >= M_real]
    if not feasible:
        return None
    M_pad = M_real if M_pad is None else int(M_pad)
    if M_pad != M_real:
        coeffs, arrays = pad_instance(coeffs, arrays, M_pad)
        warm = _pad_warm(warm, M_pad - M_real)
    lane = lane_input(arrays, coeffs, kWs, feasible, warm, margin_state, per_k_optima)
    sf = lane.sf
    params = _search_params(sf, node_cap, beam, ipm_iters, max_rounds, ipm_warm_iters,
                            lp_backend, pdhg_iters, None, pdhg_dtype, per_k_optima,
                            pdhg_restart_tol)
    if sf.moe:
        w_max, e_max = max(W for _, W in feasible), lane.E
        warm_duals = lane.duals_tuple is not None and lane.warm_tuple is not None
        decomp_steps = DECOMP_STEPS_WARM if warm_duals else DECOMP_STEPS_COLD
    else:
        w_max = e_max = decomp_steps = 0
    m, nf = sf.A.shape[1], sf.A.shape[2]
    statics = dict(
        M=M_pad, n_k=len(sf.ks), m=m, nf=nf, cap=params["cap"],
        ipm_iters=params["ipm_iters"], max_rounds=params["max_rounds"], beam=params["beam"],
        moe=sf.moe, has_warm=lane.warm_tuple is not None, w_max=w_max, e_max=e_max,
        decomp_steps=decomp_steps, has_duals=lane.duals_tuple is not None,
        per_k=per_k_optima, has_margin=lane.margin_np is not None,
        ipm_warm_iters=params["ipm_warm_iters"],
        has_root_warm=lane.root_warm_tuple is not None, lp_backend=params["lp_backend"],
        pdhg_restart_tol=(DEFAULT_RESTART_TOL if pdhg_restart_tol is None
                          else pdhg_restart_tol),
        pdhg_dtype=params["pdhg_dtype"],
    )
    return PackedInstance(
        static_np=pack_static(sf), lane=lane, statics=statics, M_real=M_real, M_pad=M_pad,
        feasible=feasible, kWs=list(kWs), mip_gap=mip_gap, nf=nf, m=m, stats=stats,
    )


def unpad_result(res: Optional[ILPResult], M_real: int) -> Optional[ILPResult]:
    """Slice a padded lane's assignment back to the real fleet (phantom
    entries are zero by their ``[0, 0]`` box); ``duals`` and ``ipm_state``
    pass through."""
    if res is None or res.w is None or len(res.w) <= M_real:
        return res
    return res.model_copy(
        update={
            "w": list(res.w[:M_real]),
            "n": list(res.n[:M_real]) if res.n is not None else None,
            "y": list(res.y[:M_real]) if res.y is not None else None,
        }
    )


def solve_batch(
    instances: Sequence[PackedInstance],
    timings: Optional[dict] = None,
    lane_pad: Optional[int] = None,
    device=None,
) -> List[Tuple[List[Optional[ILPResult]], Optional[ILPResult]]]:
    """Solve N same-signature instances as the lanes of one search on
    ``device`` (None = cuda; raises without a GPU).

    Returns ``solve_sweep_torch``'s ``(per_k_results, best)`` per instance,
    in order, padded lanes sliced back to their real fleet; each lane is
    decoded as a single sweep is (certificate, duals, margin anchor).
    ``lane_pad`` (>= N) pads the batch to a fixed lane count by repeating
    the last instance: duplicate lanes are solved and never decoded. A
    mixed-signature batch, or one with more than one ``mip_gap``, raises
    ValueError. Lanes on the PDHG engine run K5's per-element entry.
    ``timings`` gets ``batch_size``, ``lanes``, ``pack_ms``, ``solve_ms``,
    ``static_hit`` (the share of lanes whose static half was already on the
    device) and ``decode_ms``."""
    if not instances:
        return []
    sig0 = instances[0].signature
    for i, inst in enumerate(instances[1:], 1):
        if inst.signature != sig0:
            raise ValueError(
                f"solve_batch requires one bucket signature: instance {i} has "
                f"{inst.signature}, instance 0 has {sig0}; group instances by "
                f"signature first"
            )
    if len({inst.mip_gap for inst in instances}) > 1:
        raise ValueError("solve_batch takes one mip_gap for the whole batch")
    n_real = len(instances)
    if lane_pad is not None and lane_pad < n_real:
        raise ValueError(f"lane_pad {lane_pad} < batch size {n_real}")
    n_lanes = lane_pad if lane_pad is not None else n_real
    st = instances[0].statics
    dev = kernels.resolve_device(device, "solve_batch")
    t0 = time.perf_counter()
    lanes = list(instances) + [instances[-1]] * (n_lanes - n_real)
    pairs = [lane_static_to_device(inst.static_np, dev) for inst in lanes]
    m, nf = st["m"], st["nf"]

    def A_lanes():
        """The lanes' A stacked on the card: only on a static-entry miss."""
        return torch.stack([blob[: m * nf].view(m, nf) for blob, _ in pairs])

    params = {k: st[k] for k in ("cap", "beam", "ipm_iters", "ipm_warm_iters", "max_rounds",
                                 "lp_backend", "pdhg_dtype", "pdhg_restart_tol")}
    prep = _prepare([inst.lane for inst in lanes], params, instances[0].mip_gap, dev,
                    per_k=st["per_k"], A_lanes=A_lanes)
    t1 = time.perf_counter()
    out = _search(prep)
    t2 = time.perf_counter()
    decoded = []
    for b, inst in enumerate(instances):
        results, best = _decode_sweep(prep, out, b)
        if inst.stats is not None:
            inst.stats.update(ipm_iters_executed=float(out["head"][b, 3]),
                              bnb_rounds=float(out["head"][b, 4]))
        decoded.append(([unpad_result(r, inst.M_real) for r in results],
                        unpad_result(best, inst.M_real)))
    if timings is not None:
        timings.update(
            batch_size=n_real, lanes=n_lanes, pack_ms=(t1 - t0) * 1e3,
            solve_ms=(t2 - t1) * 1e3,
            static_hit=1.0 - sum(1 for _, up in pairs if up) / n_lanes,
            decode_ms=(time.perf_counter() - t2) * 1e3,
            bnb_rounds=float(out["head"][:, 4].max()), lp_backend=st["lp_backend"],
        )
    return decoded


solve_batch = _instrument("solver.solve_batch", solve_batch)


