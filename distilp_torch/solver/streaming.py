"""Streaming re-placement: the replanner that re-solves on every tick.

Profiles stream in (device load changes, t_comm drift, expert loads), each
tick re-solves warm-started from the previous placement, and the new
assignment streams out. Warm start: the previous integer assignment is
re-priced exactly under the new coefficients on the device (never trusted at
its stale objective) and seeds the incumbent, so branch-and-bound prunes
from round one. When the fleet changed shape (device count, L, dense/MoE)
the tick solves cold.

Three kinds of warm state ride ``self.last`` across ticks: the integer
assignment, the Lagrangian root multipliers (MoE bound re-certification)
and the root LP iterates (``HALDAResult.ipm_state``). A MoE replanner also
threads the margin chain (``self._margin_state``): while drift stays in the
linear channels the root bounds are re-derived on the host from the last
full evaluation (``backend_torch.margin_bounds_from_state``) and no K7
evaluation runs at all. All of it is validity-gated; staleness costs
iterations, never soundness. ``cold_start=True`` disables every one of them
for A/B measurement.

Ported from ``distilp_tpu/solver/streaming.py`` on the port's own
``halda_solve``/``halda_solve_async`` and ``batchlayout.pack_instance``
(the reference module binds the JAX package's ``halda_solve`` at import).
``backend='torch'`` (default) solves on ``device`` (None = cuda, raises
without a GPU; ``'cpu'`` runs the kernels' plain versions); ``'cpu'`` is the
HiGHS oracle. The warm-state blob (``dump_warm_state``) is the JAX
package's format, so a blob written by either package loads in the other.
"""

from __future__ import annotations

import base64
from typing import Optional, Sequence

import numpy as np

from ..common import DeviceProfile, ModelProfile
from .api import _best_to_result, _build_instance, _warm_to_ilp, halda_solve, halda_solve_async
from .moe import build_moe_arrays, model_has_moe_components
from .result import HALDAResult
from .routing import map_experts, normalize_loads

# Wire format of the warm-state blob (dump_warm_state/load_warm_state); load
# refuses versions it does not know.
WARM_BLOB_VERSION = 1


def _encode_state(obj):
    """JSON-able encoding of a warm-state payload, bit-exact for arrays:
    numpy arrays as base64 of their raw bytes with dtype and shape, numpy
    scalars with their dtype; tuples decode as lists."""
    if isinstance(obj, np.ndarray):
        return {
            "__nd__": 1,
            "dtype": str(obj.dtype),
            "shape": list(obj.shape),
            "data": base64.b64encode(np.ascontiguousarray(obj).tobytes()).decode("ascii"),
        }
    if isinstance(obj, np.generic):
        return {"__npscalar__": 1, "dtype": str(obj.dtype), "value": obj.item()}
    if isinstance(obj, dict):
        return {str(k): _encode_state(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode_state(v) for v in obj]
    return obj


def _decode_state(obj):
    if isinstance(obj, dict):
        if obj.get("__nd__") == 1:
            arr = np.frombuffer(base64.b64decode(obj["data"]), dtype=np.dtype(obj["dtype"]))
            return arr.reshape(obj["shape"]).copy()
        if obj.get("__npscalar__") == 1:
            return np.dtype(obj["dtype"]).type(obj["value"])
        return {k: _decode_state(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode_state(v) for v in obj]
    return obj


class CombinePrep:
    """One prepared combined tick: the packed instance plus what ``adopt()``
    needs to redeem the lane (made by ``StreamingReplanner.prepare``)."""

    __slots__ = ("instance", "sets", "shape", "warm_used", "devs", "model", "k_candidates")

    def __init__(self, instance, sets, shape, warm_used, devs, model, k_candidates):
        self.instance = instance
        self.sets = sets
        self.shape = shape
        self.warm_used = warm_used
        self.devs = devs
        self.model = model
        self.k_candidates = k_candidates


class StreamingReplanner:
    """Holds the previous placement and re-solves warm on every tick.

    >>> planner = StreamingReplanner(kv_bits="8bit", mip_gap=1e-3)
    >>> placement = planner.step(devs, model)       # cold solve
    >>> devs[3].t_comm *= 2.0                        # profile update streams in
    >>> placement = planner.step(devs, model)       # warm re-solve
    """

    # Search-budget overrides a replanner carries across its ticks (None
    # entries fall back to the problem-class defaults).
    _SEARCH_KEYS = (
        "max_rounds", "beam", "ipm_iters", "ipm_warm_iters", "node_cap",
        "lp_backend", "pdhg_iters", "pdhg_restart_tol", "mesh_shards",
        "pdhg_dtype",
    )

    def __init__(
        self,
        mip_gap: float = 1e-3,
        kv_bits: str = "8bit",
        backend: str = "torch",
        moe: Optional[bool] = None,
        cold_start: bool = False,
        search: Optional[dict] = None,
        diagnostics: bool = False,
        device=None,
    ) -> None:
        if backend not in ("torch", "cpu"):
            raise ValueError(f"Unknown backend {backend!r}; expected 'torch' or 'cpu'")
        self.mip_gap = mip_gap
        self.kv_bits = kv_bits
        self.backend = backend
        self.moe = moe
        self.device = device
        # A/B switch: every tick solves from scratch (no warm incumbent, no
        # stored duals, no root iterates, no margin chain).
        self.cold_start = cold_start
        self.search = dict(search or {})
        bad = set(self.search) - set(self._SEARCH_KEYS)
        if bad:
            raise ValueError(
                f"unknown search override(s) {sorted(bad)}; "
                f"valid keys: {list(self._SEARCH_KEYS)}"
            )
        # Solver-interior telemetry: every tick (sync or pipelined) solves
        # with a convergence dict, the raw report lands on last_convergence
        # (obs.convergence decodes it) and the conv_* digest rides the tick's
        # timings. The solves are the untraced ones.
        self.diagnostics = diagnostics
        self.last_convergence: dict = {}
        self.last: Optional[HALDAResult] = None
        self.last_mapping = None  # ExpertMapping of the last load-aware tick
        # Optional sink with record_tick(mode, certified, escalations).
        self.metrics = None
        self.last_tick_mode: Optional[str] = None  # 'cold' | 'warm' | 'margin'
        self.last_tick_escalations: int = 0
        self.last_tick_timings: dict = {}
        self._last_shape: Optional[tuple] = None
        self._load_factors = None  # realized per-device load multipliers
        self._in_flight: list = []
        self._margin_state: dict = {}

    def _solve_kw(self) -> dict:
        kw = dict(mip_gap=self.mip_gap, kv_bits=self.kv_bits, moe=self.moe, **self.search)
        if self.backend == "torch":
            kw["device"] = self.device
        return kw

    def _tick_inputs(self, devs, model):
        """(shape, warm, loads, factors) of a tick: the warm result when the
        fleet kept its shape, the expert loads when they are skewed, and the
        previous tick's realized load factors for them."""
        use_moe = model_has_moe_components(model) if self.moe is None else bool(self.moe)
        shape = (len(devs), model.L, use_moe)
        warm = self.last if shape == self._last_shape and not self.cold_start else None
        loads = None
        if use_moe and model.expert_loads is not None:
            loads = normalize_loads(model.expert_loads, model.n_routed_experts)
            if np.allclose(loads, 1.0):
                loads = None
        factors = self._load_factors if loads is not None else None
        if factors is not None and len(factors) != len(devs):
            factors = None  # fleet changed shape; restart the fixed point
        return shape, warm, loads, factors

    def _map_loads(self, result: HALDAResult, devs, model, loads) -> None:
        """Map concrete expert ids for a load-aware tick (the fixed point of
        ``solve_load_aware`` unrolled across the stream, one map per tick)."""
        if loads is not None and result.y is not None:
            mapping = map_experts(result.y, build_moe_arrays(devs, model).g_raw, loads)
            self.last_mapping = mapping
            self._load_factors = mapping.factors
        else:
            self.last_mapping = None
            self._load_factors = None

    def step(
        self,
        devs: Sequence[DeviceProfile],
        model: ModelProfile,
        k_candidates: Optional[Sequence[int]] = None,
        timings: Optional[dict] = None,
    ) -> HALDAResult:
        """One tick: re-solve under the current profiles, warm when possible.

        ``timings`` receives the tick's breakdown (see ``halda_solve``); a
        fallback re-solve overwrites it with its own numbers, which are that
        tick's cost. Skewed ``expert_loads`` price each device's experts at
        the previous tick's realized load factors and map expert ids after
        the solve (``self.last_mapping``).
        """
        shape, warm, loads, factors = self._tick_inputs(devs, model)
        conv = {} if (self.diagnostics and self.backend == "torch") else None
        result = halda_solve(
            devs, model, k_candidates=k_candidates, backend=self.backend, warm=warm,
            load_factors=factors, timings=timings,
            margin_state=None if self.cold_start else self._margin_state,
            convergence=conv, **self._solve_kw(),
        )
        result = self._certify_or_fallback(result, devs, model, k_candidates, factors, warm,
                                           timings, conv)
        self.last_convergence = conv if conv is not None else {}
        self._map_loads(result, devs, model, loads)
        self.last = result
        self._last_shape = shape
        self.last_tick_timings = dict(timings) if timings is not None else {}
        return result

    def _certify_or_fallback(self, result, devs, model, k_candidates, factors, warm,
                             timings, convergence=None) -> HALDAResult:
        """The certification ladder shared by ``step()`` and ``collect()``.

        Rung 1: a margin tick that missed its certificate drops the anchor
        and retries with one full bound evaluation, still warm (it also
        refreshes the anchor). Rung 2: a warm tick whose stored duals went
        stale re-solves cold (full ascent, fresh duals); MoE only, gated on
        those duals. A re-solve refills ``convergence``."""
        margin_used = self._margin_state.pop("used", False)
        escalations = 0
        if not result.certified and margin_used and warm is not None:
            escalations += 1
            self._margin_state.pop("m_y", None)
            result = halda_solve(
                devs, model, k_candidates=k_candidates, backend=self.backend, warm=warm,
                load_factors=factors, timings=timings, margin_state=self._margin_state,
                convergence=convergence, **self._solve_kw(),
            )
            self._margin_state.pop("used", None)
        if warm is not None and warm.duals is not None and not result.certified:
            escalations += 1
            result = halda_solve(
                devs, model, k_candidates=k_candidates, backend=self.backend,
                load_factors=factors, timings=timings, margin_state=self._margin_state,
                convergence=convergence, **self._solve_kw(),
            )
            self._margin_state.pop("used", None)
        self.last_tick_mode = (
            "margin" if margin_used else ("warm" if warm is not None else "cold")
        )
        self.last_tick_escalations = escalations
        if self.metrics is not None:
            self.metrics.record_tick(mode=self.last_tick_mode, certified=result.certified,
                                     escalations=escalations)
        return result

    def submit(
        self,
        devs: Sequence[DeviceProfile],
        model: ModelProfile,
        k_candidates: Optional[Sequence[int]] = None,
    ):
        """Pipelined tick, dispatch half: start a solve and return at once
        (``halda_solve_async``: build and upload here, the search on the
        port's worker thread). Pair with ``collect()``. Warm seeding uses the
        most recently collected result (one tick stale in a full pipeline),
        which is sound: hints are re-priced exactly on the device."""
        if self.backend != "torch":
            raise RuntimeError("pipelined ticks need backend='torch'")
        shape, warm, loads, factors = self._tick_inputs(devs, model)
        conv = {} if self.diagnostics else None
        pending = halda_solve_async(
            devs, model, k_candidates=k_candidates, warm=warm, load_factors=factors,
            margin_state=None if self.cold_start else self._margin_state,
            convergence=conv, **self._solve_kw(),
        )
        # Shallow snapshots of the fleet and the model: callers mutate scalar
        # fields in place and replace containers between ticks, and the
        # fallback re-solve and the expert map must price THIS tick.
        self._in_flight.append(
            (pending, shape, [d.model_copy() for d in devs], model.model_copy(), loads,
             k_candidates, factors, warm, conv)
        )
        return pending

    def collect(self) -> HALDAResult:
        """Pipelined tick, blocking half: redeem the oldest in-flight solve."""
        if not self._in_flight:
            raise RuntimeError("no in-flight tick; call submit() first")
        pending, shape, devs, model, loads, k_candidates, factors, warm, conv = \
            self._in_flight.pop(0)
        result = pending.collect()
        # Pipelined misses escalate synchronously: the pipeline hiccups,
        # correctness does not. The convergence dict was decoded by the
        # collect and is refilled by an escalation, so last_convergence
        # describes the tick just redeemed.
        result = self._certify_or_fallback(result, devs, model, k_candidates, factors, warm,
                                           None, conv)
        self.last_convergence = conv if conv is not None else {}
        self._map_loads(result, devs, model, loads)
        self.last = result
        self._last_shape = shape
        return result

    def prepare(
        self,
        devs: Sequence[DeviceProfile],
        model: ModelProfile,
        k_candidates: Optional[Sequence[int]] = None,
        M_pad: Optional[int] = None,
        warm_override=None,
    ):
        """Combined tick, pack half: this tick as a ``PackedInstance`` for a
        batch of lanes (``batchlayout.solve_batch``). Pair with ``adopt()``.

        Returns None when the tick cannot ride a batch: MoE profiles (their
        load-factor fixed point and margin ladder are multi-solve loops) or
        a backend other than 'torch'. Raises RuntimeError when no k is
        structurally feasible. Warm seeding is ``step()``'s; ``M_pad`` pads
        to a bucket boundary with phantom devices (exact);
        ``warm_override`` (an ``ILPResult``) replaces the warm hint without
        touching the replanner's state."""
        from .batchlayout import pack_instance

        if self.backend != "torch":
            return None
        use_moe = model_has_moe_components(model) if self.moe is None else bool(self.moe)
        if use_moe:
            return None
        shape, warm, _, _ = self._tick_inputs(devs, model)
        Ks, sets, coeffs, arrays = _build_instance(devs, model, k_candidates, self.kv_bits,
                                                   False, None, 1)
        # mesh_shards stays out: lanes compose as the batch.
        knobs = {key: self.search.get(key) for key in (
            "ipm_iters", "max_rounds", "beam", "node_cap", "ipm_warm_iters", "lp_backend",
            "pdhg_iters", "pdhg_restart_tol", "pdhg_dtype")}
        inst = pack_instance(
            arrays, [(k, model.L // k) for k in Ks], mip_gap=self.mip_gap, coeffs=coeffs,
            warm=warm_override if warm_override is not None else _warm_to_ilp(warm),
            M_pad=M_pad, **knobs,
        )
        if inst is None:
            raise RuntimeError("No feasible MILP found for any k.")
        return CombinePrep(
            instance=inst, sets=sets, shape=shape,
            warm_used=warm is not None or warm_override is not None,
            devs=[d.model_copy() for d in devs], model=model.model_copy(),
            k_candidates=list(k_candidates) if k_candidates else None,
        )

    def adopt(self, prep: CombinePrep, decoded, timings: Optional[dict] = None) -> HALDAResult:
        """Combined tick, redeem half: fold one lane of a batch back into
        this replanner's warm state as if ``step()`` had produced it.
        ``decoded`` is the lane's ``(per_k_results, best)`` from
        ``solve_batch``; an uncertified lane escalates to a full warm
        ``halda_solve`` of its own."""
        _, best = decoded
        if best is None:
            raise RuntimeError("No feasible MILP found for any k.")
        result = _best_to_result(best, prep.sets)
        escalations = 0
        if not result.certified:
            escalations = 1
            kw = self._solve_kw()
            kw["moe"] = False
            result = halda_solve(prep.devs, prep.model, k_candidates=prep.k_candidates,
                                 backend="torch", warm=result, timings=timings, **kw)
        self.last_tick_mode = "warm" if prep.warm_used else "cold"
        self.last_tick_escalations = escalations
        if self.metrics is not None:
            self.metrics.record_tick(mode=self.last_tick_mode, certified=result.certified,
                                     escalations=escalations)
        self.last = result
        self._last_shape = prep.shape
        self.last_mapping = None
        self._load_factors = None
        self.last_tick_timings = dict(timings) if timings is not None else {}
        return result

    def reset(self) -> None:
        self.last = None
        self.last_mapping = None
        self.last_tick_mode = None
        self.last_tick_escalations = 0
        self.last_tick_timings = {}
        self.last_convergence = {}
        self._last_shape = None
        self._load_factors = None
        self._in_flight = []
        self._margin_state = {}

    # -- warm-state snapshot/restore ------------------------------------
    #
    # The incumbent and the Lagrangian duals (``self.last``), the root LP
    # iterates (``last.ipm_state``) and the MoE margin anchor
    # (``self._margin_state``), as one JSON-able blob; the round trip is
    # bit-exact, so a restored replanner's next tick equals the
    # uninterrupted one's.

    def dump_warm_state(self) -> dict:
        """Every cross-tick warm artifact as one JSON-able blob (the inverse
        of ``load_warm_state``). Refuses while pipelined ticks are in flight:
        ``collect()`` them first."""
        if self._in_flight:
            raise RuntimeError(
                "cannot dump warm state with pipelined ticks in flight; collect() them first"
            )
        blob: dict = {
            "version": WARM_BLOB_VERSION,
            "shape": list(self._last_shape) if self._last_shape else None,
            "last": None,
            "ipm_state": None,
            "margin_state": None,
            "load_factors": _encode_state(self._load_factors),
        }
        if self.last is not None:
            blob["last"] = self.last.model_dump()
            blob["ipm_state"] = _encode_state(self.last.ipm_state)
        if self._margin_state:
            ms = {k: v for k, v in self._margin_state.items() if k != "used"}
            blob["margin_state"] = _encode_state(ms)
        return blob

    def load_warm_state(self, blob: dict) -> None:
        """Restore a ``dump_warm_state`` blob (of either package) into this
        replanner: an implicit ``reset()`` first; the configuration (gap,
        backend, device, search knobs) stays its own."""
        version = blob.get("version")
        if version != WARM_BLOB_VERSION:
            raise ValueError(
                f"unknown warm-state blob version {version!r} "
                f"(this build reads {WARM_BLOB_VERSION})"
            )
        self.reset()
        if blob.get("last") is not None:
            result = HALDAResult.model_validate(blob["last"])
            result.ipm_state = _decode_state(blob.get("ipm_state"))
            self.last = result
        shape = blob.get("shape")
        self._last_shape = tuple(shape) if shape else None
        ms = _decode_state(blob.get("margin_state"))
        self._margin_state = ms if isinstance(ms, dict) else {}
        self._load_factors = _decode_state(blob.get("load_factors"))
