"""Analytic model profiling (config-driven per-layer FLOPs and bytes).

The port's own copy of the jax-free part of ``distilp_tpu.profiler``:
``profile_model`` turns a local HF ``config.json`` (dense or MoE) into the
``ModelProfileSplit`` the solver consumes. The device microbenchmarks are a
later slice of the port.
"""

from .analytic import (
    parse_quantization_info,
    profile_model_phased,
    profile_model_split,
    profile_moe_model,
)
from .api import profile_model
from .hfconfig import HFConfig, load_config, load_config_from_repo

__all__ = [
    "profile_model",
    "profile_model_split",
    "profile_model_phased",
    "profile_moe_model",
    "parse_quantization_info",
    "HFConfig",
    "load_config",
    "load_config_from_repo",
]
