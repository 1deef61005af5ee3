"""Profiler of the port: analytic model profiling and device microbenchmarks.

``profile_model`` turns a local HF ``config.json`` (dense or MoE) into the
``ModelProfileSplit`` the solver consumes (the port's own copy of the JAX
package's config-driven profiler). ``profile_device`` microbenchmarks this
host and its CUDA card (GEMM rates per dtype through kernel K9b, the HBM
streaming rate through kernel K9a, memory, transfers, disk) into a
``DeviceProfile``.
"""

from .analytic import (
    parse_quantization_info,
    profile_model_phased,
    profile_model_split,
    profile_moe_model,
)
from .api import profile_device, profile_model
from .datatypes import DeviceInfo
from .hfconfig import HFConfig, load_config, load_config_from_repo

__all__ = [
    "profile_device",
    "profile_model",
    "DeviceInfo",
    "profile_model_split",
    "profile_model_phased",
    "profile_moe_model",
    "parse_quantization_info",
    "HFConfig",
    "load_config",
    "load_config_from_repo",
]
