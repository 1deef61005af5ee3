"""Hand-written Hopper kernels of the port and their launch counts.

The sources live in ``csrc/`` and are built at first use by
:mod:`distilp_torch.kernels.build`. Each kernel's Python wrapper sits beside
its plain PyTorch version (``ops/ipm.py``, ``ops/pdhg.py``,
``ops/meshlp.py``, ``parallel/collectives.py``, ``ops/decomp.py``,
``solver/rounding.py``, ``solver/search.py``, ``solver/device_loop.py``,
``twin/engine.py``, ``profiler/device.py``): on a CUDA tensor the wrapper
launches the kernel and adds one to :data:`LAUNCHES`; on a CPU tensor it runs
the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

# Kernel name -> launches since the last reset (only the wrappers add to it).
# The per-instance entries of K2, K2 MoE, K3 and K7 count a launch that
# carries more than one sweep (scenario or batch lanes) under "<name>_lanes",
# one that carries a single sweep under the kernel's own name. K5 counts a
# launch on one shared A as "pdhg" and one on a per-element A as
# "pdhg_elem", on either route (its shape key ends in the route:
# "route=cluster<C>" or "route=grid"); a launch of K1 or K5 that records
# the convergence trace counts as "ipm_trace" or "pdhg_trace", not under
# the untraced name. The row-sharded PDHG (K6b) counts one
# "pdhg_sharded" launch per slice on its fused route (every shard on one
# device) and one per phase per shard on its sequenced route (its
# per-element entry "pdhg_sharded_elem"; traced or not; the shape key ends
# in the route), the mesh's psum/pmax one "collective" launch per receiving
# shard. K7 breaks its launches down by entry: "ascent" (the fused ascent,
# one a call whatever its steps), "eval64" and "eval32" (the per-step entry:
# DecompBound32 and the card's yardstick of the ascent); its float64 folds
# around the evaluation count as "decomp_theta" and "decomp_bound". The round tail
# (R8: a round's rounding, incumbent, thresholds, epilogue and compaction
# in one launch, a per-k round's too) counts "round_tail", or
# "round_tail_lanes" for a launch over more than one lane. A dense
# or MoE sweep's search on the IPM or the PDHG engine is one CUDA graph
# (solver/device_loop.py): "bnb_graph" counts its launches; the kernels it
# ran ("bnb_seed", "bnb_head", "ipm" or K5 under the wrapper's "pdhg" /
# "pdhg_elem" and shape keys, for float64 PDHG iterates "bnb_cast", the
# round tail, "bnb_control", "bnb_answer", and for a MoE sweep K7, its
# folds and K2's MoE mode; on a row mesh K6b's fused launches under its
# wrapper's names and shape keys and "bnb_gather", the dual blocks back in
# full coordinates; on a node mesh K1 or K5 and K2's dense entry
# ("round_incumbent") or MoE mode once a shard) are counted from the rounds
# its answer reports, since a graph launch is one host call.
LAUNCHES: Dict[str, int] = {
    "ipm": 0, "round_incumbent": 0, "round_moe": 0, "bnb_epilogue": 0, "pdhg": 0,
    "decomp": 0, "twin_mc": 0, "hbm_stream": 0, "gemm_absmax_scale": 0,
    "bnb_per_k": 0, "price_fixed": 0, "round_incumbent_lanes": 0, "round_moe_lanes": 0,
    "bnb_epilogue_lanes": 0, "bnb_per_k_lanes": 0, "decomp_lanes": 0, "pdhg_elem": 0,
    "ipm_trace": 0, "pdhg_trace": 0, "pdhg_sharded": 0, "pdhg_sharded_elem": 0,
    "collective": 0, "round_tail": 0, "round_tail_lanes": 0, "bnb_graph": 0, "bnb_seed": 0,
    "bnb_head": 0, "bnb_control": 0, "bnb_answer": 0, "decomp_theta": 0, "decomp_bound": 0,
    "bnb_cast": 0, "bnb_gather": 0,
}


# Kernel name -> {shape: launches} for the kernels whose wrappers break
# their count down by the shape they were launched at (K1, K5, K6b), by
# entry (K7) or by dtype (K9b); "bnb_graph" counts every search by its
# loop's route ("route=graph ..." or "route=host <why> ...").
SHAPES: Dict[str, Dict[str, int]] = {"ipm": {}, "pdhg": {}, "pdhg_elem": {},
                                     "ipm_trace": {}, "pdhg_trace": {}, "pdhg_sharded": {},
                                     "pdhg_sharded_elem": {}, "decomp": {},
                                     "decomp_lanes": {}, "gemm_absmax_scale": {},
                                     "bnb_graph": {}}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for v in SHAPES.values():
        v.clear()


def count_launch(name: str, shape: str = "") -> None:
    """One launch of kernel ``name`` (and of ``shape``, where its wrapper
    breaks the count down)."""
    LAUNCHES[name] += 1
    if name in SHAPES:
        SHAPES[name][shape] = SHAPES[name].get(shape, 0) + 1


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def opt_ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None) if t is None else ptr(t)


def stream_handle(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed with cudaError {err}")


def on_cuda(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on a CUDA device, False when all lie on
    the CPU; raises on a mix (the wrapper would otherwise pick a route for
    tensors that cannot be used together)."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on mixed or unsupported devices: {sorted(kinds)}")


def resolve_device(device, what: str, hint: str = "") -> torch.device:
    """``None`` means the first CUDA device and raises when there is none:
    an entry point of the port never drops to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA device and none is available; pass "
                f"device='cpu' to run the plain PyTorch versions of the "
                f"kernels{hint}"
            )
        return torch.device("cuda")
    return torch.device(device)
