"""Profiler entry points of the port.

``profile_model`` — the analytic model profiler from a local HF
``config.json`` (``distilp_tpu/profiler/api.py::profile_model``): per-layer
FLOPs and bytes from the config alone, so a ``ModelProfile`` (dense or MoE)
can be built on a host without JAX.
``profile_device`` — microbenchmark this host and its CUDA card for a
model's shapes (``distilp_tpu/profiler/api.py::profile_device``).
"""

from __future__ import annotations

from typing import List, Optional

from ..common import DeviceProfile, ModelProfileSplit
from . import device as _device
from .analytic import profile_model_split
from .hfconfig import ConfigSource, load_config


def profile_model(
    source: ConfigSource,
    batch_sizes: Optional[List[int]] = None,
    sequence_length: int = 512,
) -> ModelProfileSplit:
    """Analytically profile a model (reference api.py:12-51).

    Args:
        source: config.json path or directory, config dict, or HFConfig.
        batch_sizes: batch sizes to tabulate (default [1, 2, 4, 8]).
        sequence_length: profiling sequence length (default 512).
    """
    batches = batch_sizes or [1, 2, 4, 8]
    cfg = load_config(source)
    return profile_model_split(
        cfg,
        B=batches[0],
        L=sequence_length,
        bs_list=batches,
    )


def profile_device(
    source: ConfigSource,
    max_batch_exp: int = 6,
    is_head: bool = True,
    raw_info=None,
    device=None,
) -> DeviceProfile:
    """Microbenchmark this host and ``device`` (None = cuda, raising without
    a GPU; 'cpu' runs the host probes only) for the given model's shapes.
    ``raw_info``: see ``device.profile_device``."""
    cfg = load_config(source)
    return _device.profile_device(
        cfg, max_batch_exp=max_batch_exp, is_head=is_head, raw_info=raw_info,
        device=device,
    )
