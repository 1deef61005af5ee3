"""HALDA placement solver on PyTorch/CUDA: GPU backend + CPU/HiGHS oracle."""

from .api import halda_solve
from .backend_torch import resolve_device
from .coeffs import (
    HaldaCoeffs,
    assign_sets,
    build_coeffs,
    valid_factors_of_L,
)
from .result import HALDAResult, ILPResult

__all__ = [
    "halda_solve",
    "resolve_device",
    "HALDAResult",
    "ILPResult",
    "HaldaCoeffs",
    "build_coeffs",
    "assign_sets",
    "valid_factors_of_L",
]
