"""Solver result types."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from pydantic import BaseModel, Field

from ..common import DeviceProfile


class ILPResult(BaseModel):
    """Solution of one fixed-k subproblem.

    The JAX backend's k-sweep returns one winning entry with the full integer
    assignment plus reporting-only entries for the other k's: those carry the
    best *found* incumbent objective for that k with ``w``/``n`` left as
    ``None`` (re-deriving the losing assignments would cost another solve) and
    ``certified=False``. The reference returns certified per-k optima
    (upstream distilp src/distilp/solver/halda_p_solver.py:392-412); consumers
    that need a losing k's assignment should re-solve with
    ``k_candidates=[k]``.
    """

    k: int
    w: Optional[List[int]] = None
    n: Optional[List[int]] = None
    obj_value: float
    # MoE co-assignment: routed experts hosted per device (None in dense mode)
    y: Optional[List[int]] = None
    # Optimality certificate: achieved relative gap (incumbent - best bound)
    # / |incumbent| when the backend computed one, and whether it met the
    # requested mip_gap. The CPU/HiGHS backend certifies by construction.
    certified: bool = True
    gap: Optional[float] = None
    # Best Lagrangian root multipliers of the solve ({"lam": (n_k,), "mu":
    # (n_k,), "tau": (n_k, M)} as nested lists; JAX MoE solves only). A
    # streaming tick feeds them back as the ascent's starting point, so the
    # warm re-certification needs a short polish instead of the full cold
    # ascent — the bound is valid at ANY multiplier vector.
    duals: Optional[Dict[str, List]] = None
    # Root-round IPM iterates ({"ok", "v", "y", "z", "f"} numpy arrays, one
    # row per k; JAX solves only): the next streaming tick ships them back
    # so its root LP solves start from this tick's iterates instead of the
    # mid-box cold point. Search state, not part of the certificate —
    # excluded from serialization (a reloaded result simply re-solves its
    # roots cold).
    ipm_state: Optional[dict] = Field(default=None, exclude=True, repr=False)


class HALDAResult(BaseModel):
    """Best placement over the k-sweep."""

    w: List[int]
    n: List[int]
    k: int
    obj_value: float
    sets: Dict[str, List[int]]
    # MoE co-assignment: routed experts hosted per device (None in dense mode)
    y: Optional[List[int]] = None
    # Optimality certificate of the winning solve (see ILPResult.certified).
    certified: bool = True
    gap: Optional[float] = None
    # Lagrangian root multipliers for warm-starting the next streaming tick
    # (see ILPResult.duals).
    duals: Optional[Dict[str, List]] = None
    # Root IPM iterates for cross-tick warm starts (see ILPResult.ipm_state;
    # excluded from serialization).
    ipm_state: Optional[dict] = Field(default=None, exclude=True, repr=False)

    def solution_text(self, devices: Sequence[DeviceProfile]) -> str:
        lines = [
            "",
            "=" * 60,
            "HALDA Solution",
            "=" * 60,
            "",
            f"Optimal k: {self.k}",
            f"Objective value: {self.obj_value:.6f}",
            "",
            "Layer distribution (w):",
        ]
        total = sum(self.w) or 1
        for dev, wi in zip(devices, self.w):
            lines.append(f"  {dev.name:40s}: {wi:3d} layers ({wi / total * 100:5.1f}%)")
        lines.append("")
        lines.append("GPU assignments (n):")
        for dev, ni in zip(devices, self.n):
            if ni > 0:
                lines.append(f"  {dev.name:40s}: {ni:3d} layers on GPU")
            else:
                lines.append(f"  {dev.name:40s}: CPU only")
        if self.y is not None:
            lines.append("")
            lines.append("Expert placement (y, routed experts per MoE layer):")
            for dev, yi in zip(devices, self.y):
                lines.append(f"  {dev.name:40s}: {yi:3d} experts")
        lines.append("")
        lines.append("Device sets:")
        for set_name in ("M1", "M2", "M3"):
            members = self.sets.get(set_name, [])
            if members:
                names = ", ".join(devices[i].name for i in members)
                lines.append(f"  {set_name}: {names}")
        return "\n".join(lines)

    def print_solution(self, devices: Sequence[DeviceProfile]) -> None:
        print(self.solution_text(devices))
