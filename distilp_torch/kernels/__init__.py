"""Hand-written Hopper kernels of the port and their launch counts.

The sources live in ``csrc/`` and are built at first use by
:mod:`distilp_torch.kernels.build`. Each kernel's Python wrapper sits beside
its plain PyTorch version (``ops/ipm.py``, ``ops/pdhg.py``,
``ops/decomp.py``, ``solver/rounding.py``, ``solver/search.py``): on a CUDA tensor the wrapper
launches the kernel and adds one to :data:`LAUNCHES`; on a CPU tensor it runs
the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

# Kernel name -> launches since the last reset (only the wrappers add to it).
LAUNCHES: Dict[str, int] = {
    "ipm": 0, "round_incumbent": 0, "round_moe": 0, "bnb_epilogue": 0, "pdhg": 0,
    "decomp": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
