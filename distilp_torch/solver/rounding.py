"""Exact integer rounding of dense LP points to MILP incumbents.

Given integer (w, n) the minimal feasible slacks are closed-form and the
optimal continuous block is z_i = max(0, B_i + F_i - C), C = max_i(B_i +
F_i/2), so the rounded point's objective is exact (float64), not an LP
approximation. :func:`round_to_incumbent` launches the CUDA kernel
(``kernels/csrc/round_kernel.cu``, one warp per row) on CUDA tensors and runs
:func:`round_to_incumbent_reference`, the plain PyTorch version, on CPU
tensors. Both compute the dense branch of
``distilp_tpu/solver/backend_jax.py::_round_to_incumbent`` with its
``_int_redistribute`` scan.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from .standard_form import RD_VEC_FIELDS

# The dense vectors the kernel reads, packed as rows of one (13, M) matrix
# whose last row is b' broadcast (see pack_rounding_data).
KERNEL_RD_FIELDS = RD_VEC_FIELDS[:12]


class RoundingData(NamedTuple):
    """Exact (float64) per-device MILP data of the rounding heuristic; the
    MoE vectors are zeros in dense mode."""

    a: torch.Tensor  # (M,)
    b_gpu: torch.Tensor
    pen_set: torch.Tensor
    pen_vram: torch.Tensor
    busy_const: torch.Tensor
    s_disk: torch.Tensor
    ram_rhs: torch.Tensor
    ram_minus_n: torch.Tensor
    cuda_rhs: torch.Tensor  # +inf when the row is inactive
    metal_rhs: torch.Tensor  # +inf when the row is inactive
    has_gpu: torch.Tensor
    g_raw: torch.Tensor
    eb_ram: torch.Tensor
    eb_vram: torch.Tensor
    eb_metal: torch.Tensor
    w_active: torch.Tensor  # 0 pins a phantom pad device to w = 0
    bprime: torch.Tensor  # ()
    E: torch.Tensor  # () routed experts (0 = dense)


def rounding_data(rd_np: dict, device) -> RoundingData:
    return RoundingData(
        **{
            k: torch.as_tensor(rd_np[k], dtype=torch.float64, device=device)
            for k in RoundingData._fields
        }
    )


def pack_rounding_data(rd: RoundingData) -> torch.Tensor:
    """The kernel's (13, M) float64 view of ``rd``: the dense vectors, then
    b' broadcast over a row. A sweep packs once and reuses it every round."""
    rows = [getattr(rd, f) for f in KERNEL_RD_FIELDS]
    rows.append(rd.bprime.to(torch.float64).expand_as(rd.a))
    return torch.stack(rows).contiguous()


def round_to_incumbent(
    v: torch.Tensor,
    W: torch.Tensor,
    k: torch.Tensor,
    rd: RoundingData,
    packed: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(obj_linear (B,), w (B, M), n (B, M)), float64, of the rows of LP
    points ``v`` (B, nf) at layers-per-segment ``W`` and segments ``k``
    (both (B,) float64). ``obj_linear`` is +inf where rounding failed.
    ``packed`` is :func:`pack_rounding_data` of ``rd``, when the caller
    keeps one."""
    if kernels.on_cuda(v, W, k, rd.a):
        return _round_kernel(v, W, k, rd, packed)
    return round_to_incumbent_reference(v, W, k, rd)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def round_to_incumbent_reference(
    v: torch.Tensor, W: torch.Tensor, k: torch.Tensor, rd: RoundingData
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the rounding kernel."""
    f64 = torch.float64
    M = rd.a.shape[0]
    v = v.to(f64)
    Wf = W.to(f64)[:, None]
    k_f = k.to(f64)
    w_frac = v[:, :M]
    n_frac = v[:, M : 2 * M]
    inf = torch.tensor(float("inf"), dtype=f64, device=v.device)
    zero = torch.zeros((), dtype=f64, device=v.device)

    rem = w_frac - torch.floor(w_frac)
    w_lo = rd.w_active.expand_as(w_frac)
    w_hi = Wf * rd.w_active
    w = _clip(torch.floor(w_frac), w_lo, w_hi)
    # _int_redistribute: M + 4 unit moves toward sum(w) == W, largest
    # remainder first on the way up, smallest on the way down.
    d = Wf[:, 0] - w.sum(1)
    for _ in range(M + 4):
        i_add = torch.where(w < w_hi, rem, -inf).argmax(1)
        i_sub = torch.where(w > w_lo, -rem, -inf).argmax(1)
        up, down = d > 0, d < 0
        idx = torch.where(up, i_add, i_sub)[:, None]
        delta = torch.where(up, 1.0, torch.where(down, -1.0, 0.0)).to(f64)
        w = w.scatter_add(1, idx, delta[:, None])
        d = torch.where(up, d - 1.0, torch.where(down, d + 1.0, d))
    valid = w.sum(1) == Wf[:, 0]

    n = _clip(torch.round(n_frac), zero, w) * rd.has_gpu
    bp = rd.bprime
    fetch = bp / rd.s_disk * w
    resident = bp * w - bp * n * rd.ram_minus_n
    viol_ram = torch.clamp(resident - rd.ram_rhs, min=0.0)
    s_ram = torch.ceil(viol_ram / bp - 1e-9)
    ok = (s_ram <= torch.minimum(w, Wf)).all(1)
    viol_vram = torch.clamp(
        torch.maximum(bp * n - rd.cuda_rhs, bp * n - rd.metal_rhs), min=0.0
    )
    viol_vram = torch.where(torch.isfinite(viol_vram), viol_vram, zero)
    t = torch.ceil(viol_vram / bp - 1e-9)
    ok &= (t <= Wf * rd.has_gpu + 1e-9).all(1)
    pen_cost = rd.pen_set * s_ram + rd.pen_vram * t
    lin = rd.a * w + rd.b_gpu * n + pen_cost
    busy = lin + rd.busy_const
    C = (busy + 0.5 * fetch).amax(1)
    obj = torch.where(valid & ok, (k_f - 1.0) * C + lin.sum(1), inf)
    return obj, w, n


def _round_kernel(v, W, k, rd: RoundingData, packed=None):
    from ..kernels.build import library

    if v.dim() != 2:
        raise ValueError(f"v must be (B, nf), got {tuple(v.shape)}")
    B = v.shape[0]
    M = rd.a.shape[0]
    if v.shape[1] < 2 * M:
        raise ValueError(f"v has {v.shape[1]} columns, fewer than 2M = {2 * M}")
    if v.dtype == torch.float32:
        fn_name = "dtk_round_f32"
    elif v.dtype == torch.float64:
        fn_name = "dtk_round_f64"
    else:
        raise TypeError(f"rounding kernel takes float32 or float64 v, got {v.dtype}")
    v = v.contiguous()
    dev = v.device
    Wr = W.to(torch.float64).contiguous()
    kr = k.to(torch.float64).contiguous()
    if Wr.shape != (B,) or kr.shape != (B,):
        raise ValueError("W and k must be (B,)")
    if packed is None:
        packed = pack_rounding_data(rd)
    if packed.shape != (len(KERNEL_RD_FIELDS) + 1, M) or packed.dtype != torch.float64:
        raise ValueError("packed rounding data must be float64 (13, M)")
    obj = torch.empty(B, dtype=torch.float64, device=dev)
    w = torch.empty((B, M), dtype=torch.float64, device=dev)
    n = torch.empty((B, M), dtype=torch.float64, device=dev)
    if B == 0:
        return obj, w, n
    P = kernels.ptr
    err = getattr(library("round"), fn_name)(
        P(v), v.shape[1], P(Wr), P(kr), P(packed), M, B,
        P(obj), P(w), P(n), kernels.stream_handle(dev),
    )
    kernels.check(err, "round_incumbent")
    kernels.LAUNCHES["round_incumbent"] += 1
    return obj, w, n
