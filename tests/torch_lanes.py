"""One sweep's search arrays as the L = 1 lane batch the port's search
takes, and back. Shared by the search tests and ``chip_smoke.py``; torch
only, so the smoke can load it without JAX."""

import torch

from distilp_torch.solver.rounding import RoundingData, pack_rounding_data
from distilp_torch.solver.search import BDTYPE, SearchState, SweepData


def lane_data(data: SweepData) -> SweepData:
    """A single sweep's data (no lane axis, ``obj_const`` a float) as the
    L = 1 lane batch; its A stays the shared (m, nf) matrix."""
    dev = data.b_k.device
    packed = pack_rounding_data(data.rd) if data.rd_packed is None else data.rd_packed
    return data._replace(
        b_k=data.b_k[None], c_k=data.c_k[None], int_mask=data.int_mask[None],
        ks=data.ks[None], Ws=data.Ws[None],
        obj_const=torch.as_tensor(data.obj_const, dtype=BDTYPE, device=dev).reshape(1),
        rd=RoundingData(*[getattr(data.rd, f)[None] for f in RoundingData._fields]),
        rd_packed=packed[None],
        gky=None if data.gky is None else data.gky[None],
    )


def lane_state(state: SearchState) -> SearchState:
    """A single sweep's state as the L = 1 lane batch."""
    return SearchState(*[t[None] for t in state])


def unlane_state(state: SearchState, q: int = 0) -> SearchState:
    """Lane ``q`` of a lane batch as a single sweep's state."""
    return SearchState(*[t[q] for t in state])
