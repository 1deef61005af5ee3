"""LP relaxation engines of the port."""

from .ipm import (
    IPMResult,
    IPMWarmState,
    LPBatch,
    ipm_solve_batch,
    ipm_solve_batch_reference,
)
from .meshlp import pdhg_solve_batch_mp, pdhg_solve_batch_sharded
from .pdhg import (
    PDHGWarmState,
    pdhg_solve_batch,
    pdhg_solve_batch_reference,
)

__all__ = [
    "IPMResult",
    "IPMWarmState",
    "LPBatch",
    "PDHGWarmState",
    "ipm_solve_batch",
    "ipm_solve_batch_reference",
    "pdhg_solve_batch",
    "pdhg_solve_batch_mp",
    "pdhg_solve_batch_sharded",
    "pdhg_solve_batch_reference",
]
