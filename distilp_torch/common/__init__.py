"""Profile schemas: the JSON contracts shared by profiler and solver.

Always importable with only pydantic installed; the heavy deps (torch, scipy)
live behind the solver subpackage, mirroring the reference's
load-bearing extras split (reference pyproject.toml:17-26).
"""

from .device import DeviceProfile, ThroughputTable
from .loaders import (
    load_device_profile,
    load_devices_and_model,
    load_from_profile_folder,
    load_model_profile,
)
from .model import ModelProfile, ModelProfilePhased, ModelProfileSplit
from .types import (
    ALL_QUANT_LEVELS,
    KV_BITS_FACTORS,
    ModelPhase,
    QuantizationLevel,
    kv_bits_to_factor,
)

__all__ = [
    "DeviceProfile",
    "ThroughputTable",
    "ModelProfile",
    "ModelProfilePhased",
    "ModelProfileSplit",
    "ModelPhase",
    "QuantizationLevel",
    "ALL_QUANT_LEVELS",
    "KV_BITS_FACTORS",
    "kv_bits_to_factor",
    "load_device_profile",
    "load_model_profile",
    "load_devices_and_model",
    "load_from_profile_folder",
]
