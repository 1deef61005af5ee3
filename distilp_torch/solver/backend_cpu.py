"""CPU oracle backend: the assembled MILP handed to scipy.optimize.milp (HiGHS).

This is the conformance oracle for the GPU backend — same
:mod:`distilp_torch.solver.assemble` arrays, solved by branch-and-cut on the
host. Golden fixture objectives must match the upstream solver
(upstream distilp src/distilp/solver/halda_p_solver.py:340-366) to full
precision because the formulation is identical.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .assemble import MilpArrays
from .result import ILPResult


class Infeasible(RuntimeError):
    """The fixed-k subproblem has no feasible assignment."""


def solve_fixed_k_cpu(
    arrays: MilpArrays,
    k: int,
    W: int,
    time_limit: Optional[float] = None,
    mip_gap: Optional[float] = 1e-4,
) -> ILPResult:
    """Solve one fixed-k subproblem with scipy's MILP (HiGHS branch-and-cut)."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    lay = arrays.layout
    lb, ub = arrays.bounds_for_k(W)
    c = arrays.c_for_k(k)
    b_eq = arrays.b_eq_for_k(W)

    constraints = [
        LinearConstraint(arrays.A_ub_for_k(k), -np.inf, arrays.b_ub),
        LinearConstraint(arrays.A_eq, b_eq, b_eq),
    ]

    options = {}
    if time_limit is not None:
        options["time_limit"] = float(time_limit)
    if mip_gap is not None:
        options["mip_rel_gap"] = float(mip_gap)

    res = milp(
        c=c,
        integrality=arrays.integrality,
        bounds=Bounds(lb, ub),
        constraints=constraints,
        options=options,
    )
    if not res.success:
        raise Infeasible(f"No feasible MILP found for k={k}.")

    x = res.x
    M = lay.M
    w = [int(round(x[lay.w(i)])) for i in range(M)]
    n = [int(round(x[lay.n(i)])) for i in range(M)]
    y = [int(round(x[lay.y(i)])) for i in range(M)] if lay.moe else None
    obj = float(c @ x) + arrays.obj_const
    return ILPResult(k=k, w=w, n=n, y=y, obj_value=obj)
