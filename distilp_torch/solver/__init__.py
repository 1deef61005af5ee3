"""HALDA placement solver on PyTorch/CUDA: GPU backend + CPU/HiGHS oracle."""

from .api import (
    PendingHalda,
    halda_solve,
    halda_solve_async,
    halda_solve_per_k,
    halda_solve_scenarios,
)
from .backend_torch import resolve_device
from .batchlayout import (
    PackedInstance,
    clear_lane_static_cache,
    lane_static_to_device,
    pack_instance,
    pad_instance,
    solve_batch,
    unpad_result,
)
from .coeffs import (
    HaldaCoeffs,
    alpha_beta_xi,
    assign_sets,
    b_cio,
    b_prime,
    build_coeffs,
    kappa_constant,
    valid_factors_of_L,
)
from .moe import MoEArrays, adjust_model, build_moe_arrays, model_has_moe_components
from .result import HALDAResult, ILPResult
from .routing import (
    ExpertMapping,
    expert_makespan,
    map_experts,
    normalize_loads,
    realized_objective,
    solve_load_aware,
)
from .streaming import StreamingReplanner

__all__ = [
    "halda_solve",
    "halda_solve_async",
    "halda_solve_per_k",
    "halda_solve_scenarios",
    "PendingHalda",
    "StreamingReplanner",
    "PackedInstance",
    "clear_lane_static_cache",
    "lane_static_to_device",
    "pack_instance",
    "pad_instance",
    "solve_batch",
    "unpad_result",
    "ExpertMapping",
    "expert_makespan",
    "map_experts",
    "normalize_loads",
    "realized_objective",
    "solve_load_aware",
    "MoEArrays",
    "adjust_model",
    "build_moe_arrays",
    "model_has_moe_components",
    "HALDAResult",
    "ILPResult",
    "HaldaCoeffs",
    "build_coeffs",
    "b_prime",
    "alpha_beta_xi",
    "b_cio",
    "assign_sets",
    "kappa_constant",
    "valid_factors_of_L",
    "resolve_device",
]
