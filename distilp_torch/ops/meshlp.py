"""Mixed-precision PDHG with the per-element float64 re-solve: the
single-device part of ``distilp_tpu/ops/meshlp.py``.

:func:`pdhg_solve_batch_mp` runs the PDHG engine (kernel K5 on CUDA tensors)
at ``dtype`` iterate precision; an element whose run comes back not converged
or with a non-finite bound is re-solved in float64 and spliced back element
by element. Precision is an optimization that can cost a re-solve, never
soundness: the certificate is the float64 Lagrangian bound either way.

The row-sharded engine of the reference (``sharded_pdhg``, one program over a
device mesh) is a later slice of the port (ROADMAP.md A13): ``mesh_shards``
above 1 raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from .ipm import IPMResult, LPBatch
from .pdhg import PDHG_DEFAULT_CHUNK, pdhg_solve_batch, resolve_pdhg_dtype


def pdhg_solve_batch_mp(
    batch: LPBatch,
    mesh_shards: int = 1,
    iters: int = 1000,
    tol: Optional[float] = None,
    restart_tol: Optional[float] = None,
    warm=None,
    skip: Optional[torch.Tensor] = None,
    chunk: int = PDHG_DEFAULT_CHUNK,
    trace: bool = False,
    dtype: str = "f32",
    f64_fallback: bool = True,
    fallback_report: Optional[dict] = None,
) -> IPMResult:
    """PDHG at ``dtype`` iterate precision with the float64 fallback.
    ``fallback_report`` (a dict) receives ``n_fallback``, the number of
    elements re-solved in float64."""
    resolve_pdhg_dtype(dtype)  # validate the spelling first, as the reference
    if int(mesh_shards) != 1:
        raise NotImplementedError(
            f"mesh_shards={mesh_shards}: the row-sharded PDHG runs across GPUs, "
            f"a later slice of the port (ROADMAP.md A13)"
        )
    kw = dict(iters=iters, tol=tol, restart_tol=restart_tol, warm=warm,
              skip=skip, chunk=chunk, trace=trace)
    res = pdhg_solve_batch(batch, dtype=dtype, **kw)
    n_bad = 0
    if f64_fallback and dtype != "f64":
        bad = ~res.converged | ~torch.isfinite(res.bound)
        n_bad = int(bad.sum())
        if n_bad:
            res64 = pdhg_solve_batch(batch, dtype="f64", **kw)

            def splice(a, a64):
                if a is None:  # no trace buffer
                    return None
                sel = bad.reshape((-1,) + (1,) * (a.dim() - 1))
                return torch.where(sel, a64.to(a.dtype), a)

            res = IPMResult(*(splice(a, a64) for a, a64 in zip(res, res64)))
    if fallback_report is not None:
        fallback_report["n_fallback"] = n_bad
    return res
