"""LP relaxation engines of the port."""

from .ipm import (
    IPMResult,
    IPMWarmState,
    LPBatch,
    ipm_solve_batch,
    ipm_solve_batch_reference,
)

__all__ = [
    "IPMResult",
    "IPMWarmState",
    "LPBatch",
    "ipm_solve_batch",
    "ipm_solve_batch_reference",
]
