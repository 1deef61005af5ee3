"""Analytic model profiling from a local HF ``config.json``.

The port's copy of the JAX package's jax-free model profiler
(``distilp_tpu/profiler/api.py::profile_model``): per-layer FLOPs and bytes
from the config alone, so a ``ModelProfile`` (dense or MoE) can be built on a
host without JAX. The device probes are not part of the port yet.
"""

from __future__ import annotations

from typing import List, Optional

from ..common import ModelProfileSplit
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
