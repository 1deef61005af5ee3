"""Interconnect probing of the port (``distilp_tpu/profiler/topology.py``).

On one visible device there is nothing to probe: ``measure_interconnect``
returns ``InterconnectInfo(num_devices=1)`` with provenance "unmeasured",
as the JAX package does below two devices, and the solver keeps the profile
scalar ``t_comm``. The collectives over several GPUs (``_collective_times``,
kernel K9c) and the communication time they give wait for the multi-GPU
slice (ROADMAP A13): both raise on several devices.
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import kernels
from .datatypes import InterconnectInfo

_LATER = ("timing collectives across GPUs (kernel K9c) is not part of the port "
          "yet (ROADMAP.md A13)")


def measure_interconnect(device=None) -> InterconnectInfo:
    """Interconnect characteristics of the devices ``device``'s type shows
    (None = cuda, raising without a GPU; 'cpu' is one device)."""
    dev = kernels.resolve_device(device, "measure_interconnect")
    n = torch.cuda.device_count() if dev.type == "cuda" else 1
    if n < 2:
        return InterconnectInfo(num_devices=n)  # provenance "unmeasured"
    raise NotImplementedError(
        f"{n} visible GPUs: {_LATER}; make one GPU visible "
        "(CUDA_VISIBLE_DEVICES) to profile a single device"
    )


def estimate_t_comm(
    payload_bytes: int = 1024 * 1024,
    info: Optional[InterconnectInfo] = None,
) -> float:
    """Per-round inter-device time for a payload: 0.0 on one device (the
    only interconnect the port measures); ``info`` defaults to
    :func:`measure_interconnect` on cuda."""
    if info is None:
        info = measure_interconnect()
    if info.num_devices < 2:
        return 0.0
    raise NotImplementedError(f"{info.num_devices} devices: {_LATER}")
