"""Exact integer rounding of LP points to MILP incumbents (kernel K2).

Given integer (w, n, y) the minimal feasible slacks are closed-form and the
optimal continuous block is z_i = max(0, B_i + F_i - C), C = max_i(B_i +
F_i/2), so the rounded point's objective is exact (float64), not an LP
approximation. :func:`round_to_incumbent` launches a CUDA kernel on CUDA
tensors and runs the plain PyTorch version on CPU tensors:

- dense rows: ``kernels/csrc/round_kernel.cu`` (one warp per row) and
  :func:`round_to_incumbent_reference`;
- MoE rows (``moe=True``): ``kernels/csrc/round_moe_kernel.cu`` (one block
  per row) and :func:`round_moe_reference`. The expert counts y come from
  the LP point by floor and largest-remainder redistribution, or from a
  Lagrangian-primal hint by ``y_steps`` exact-priced greedy repair steps;
  then ``moves`` steps of the best i -> j transfer of 1, 2, 4, 8 or 16
  experts over all 5 M M candidates;
- fixed MoE assignments (:func:`price_fixed_assignment`, B14): the same
  pricer alone, with no rounding (``round_moe_kernel.cu``'s
  ``dtk_price_fixed_f64``).

Several sweeps round in one launch (scenarios, batch lanes: the
reference's vmap over sweeps): ``rd`` then holds one instance per leading
index (:func:`stack_rounding_data`; vectors (R, M), ``bprime`` and ``E``
(R,)) and ``inst`` gives each row its instance. The plain versions round
each instance's rows on their own.

Both compute ``distilp_tpu/solver/backend_jax.py::_round_to_incumbent`` with
its ``_int_redistribute`` scan. The MoE pricer sums the devices' linear
costs in device order 0..M-1 in the kernel and in the plain version alike,
so equal-cost candidates tie the same way in both.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import kernels
from .standard_form import MOE_LOCAL_MOVES, RD_VEC_FIELDS

# The vectors the kernels read, packed as rows of one (17, M) matrix: the
# twelve dense vectors, b' broadcast, then the four MoE vectors (see
# pack_rounding_data).
KERNEL_RD_FIELDS = RD_VEC_FIELDS[:12]
MOE_RD_FIELDS = RD_VEC_FIELDS[12:]
PACKED_ROWS = len(KERNEL_RD_FIELDS) + 1 + len(MOE_RD_FIELDS)
# Threads a block of the MoE rounding kernel (one block a row; its move
# search spreads the 5 M^2 candidates over them: 768 beat 256 and 512 on
# the flagship's rows, and 1024 do not fit its registers) and of the
# fixed-assignment pricer (B14: one thread sums, the rest set up).
MOE_THREADS = 768
PRICE_FIXED_THREADS = 256
# Transfer sizes of the move search (JAX: qs).
MOVE_QUANTA = (1.0, 2.0, 4.0, 8.0, 16.0)


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
    """The kernels' (17, M) float64 view of ``rd`` ((R, 17, M) for a stack
    of R instances): the dense vectors, b' broadcast over a row, then the
    MoE vectors. A sweep packs once and reuses it every round."""
    rows = [getattr(rd, f) for f in KERNEL_RD_FIELDS]
    rows.append(rd.bprime.to(torch.float64)[..., None].expand_as(rd.a))
    rows += [getattr(rd, f) for f in MOE_RD_FIELDS]
    return torch.stack(rows, dim=-2).contiguous()


def stack_rounding_data(rds) -> RoundingData:
    """R instances' rounding data as one stack: vectors (R, M), ``bprime``
    and ``E`` (R,)."""
    return RoundingData(*[torch.stack([getattr(r, f) for r in rds])
                          for f in RoundingData._fields])


def rd_instance(rd: RoundingData, q: int) -> RoundingData:
    """Instance ``q`` of a stack (:func:`stack_rounding_data`)."""
    return RoundingData(*[getattr(rd, f)[q] for f in RoundingData._fields])


def round_to_incumbent(
    v: torch.Tensor,
    W: torch.Tensor,
    k: torch.Tensor,
    rd: RoundingData,
    packed: Optional[torch.Tensor] = None,
    moe: bool = False,
    y_steps: Optional[int] = None,
    moves: int = MOE_LOCAL_MOVES,
    inst: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """(obj_linear (B,), w (B, M), n (B, M)), float64, of the rows of LP
    points ``v`` (B, nf) at layers-per-segment ``W`` and segments ``k``
    (both (B,) float64). ``obj_linear`` is +inf where rounding failed.
    ``packed`` is :func:`pack_rounding_data` of ``rd``, when the caller
    keeps one. With a stack of instances in ``rd``, ``inst`` (B,) names
    each row's (None: instance 0 for every row).

    ``moe=True`` also rounds the expert counts ``v[:, 2M:3M]`` and returns
    ``(obj_linear, w, n, y)``: LP points (``y_steps=None``) by floor and
    largest-remainder redistribution, hints by ``y_steps`` greedy repair
    steps; then ``moves`` expert-move steps."""
    if kernels.on_cuda(v, W, k, rd.a):
        if moe:
            return _round_moe_kernel(v, W, k, rd, packed, y_steps, moves, inst)
        return _round_kernel(v, W, k, rd, packed, inst)
    if moe:
        return _by_instance(round_moe_reference, v, W, k, rd, inst, y_steps, moves)
    return _by_instance(round_to_incumbent_reference, v, W, k, rd, inst)


def _by_instance(fn, v, W, k, rd: RoundingData, inst, *args):
    """A plain single-instance version over rows of several instances: each
    instance's rows on their own, the results back in row order."""
    if rd.a.dim() == 1:
        return fn(v, W, k, rd, *args)
    B = v.shape[0]
    if inst is None:
        inst = torch.zeros(B, dtype=torch.int64, device=v.device)
    groups = torch.unique(inst).tolist() if B else [0]
    outs = None
    for q in groups:
        rows = (inst == q).nonzero()[:, 0]
        got = fn(v[rows], W[rows], k[rows], rd_instance(rd, q), *args)
        if outs is None:
            outs = [torch.empty((B, *t.shape[1:]), dtype=t.dtype, device=t.device)
                    for t in got]
        for o, t in zip(outs, got):
            o[rows] = t
    return tuple(outs)


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def _int_redistribute(vals, rem, lo, hi, target):
    """``_int_redistribute``: M + 4 unit moves of the rows of ``vals``
    toward sum == ``target`` (B,), largest remainder first on the way up,
    smallest on the way down; ``lo``/``hi`` broadcast against ``vals``."""
    M = vals.shape[1]
    ninf = torch.tensor(float("-inf"), dtype=vals.dtype, device=vals.device)
    d = target - vals.sum(1)
    for _ in range(M + 4):
        i_add = torch.where(vals < hi, rem, ninf).argmax(1)
        i_sub = torch.where(vals > lo, -rem, ninf).argmax(1)
        up, down = d > 0, d < 0
        idx = torch.where(up, i_add, i_sub)[:, None]
        delta = torch.where(up, 1.0, torch.where(down, -1.0, 0.0)).to(vals.dtype)
        vals = vals.scatter_add(1, idx, delta[:, None])
        d = torch.where(up, d - 1.0, torch.where(down, d + 1.0, d))
    return vals


def _round_w_n(v, W, rd: RoundingData):
    """(w, n, valid) of the dense rounding: floored layer counts
    redistributed to sum W, GPU layers rounded into [0, w]."""
    f64 = torch.float64
    M = rd.a.shape[0]
    Wf = W.to(f64)[:, None]
    w_frac = v[:, :M]
    n_frac = v[:, M : 2 * M]
    zero = torch.zeros((), dtype=f64, device=v.device)
    rem = w_frac - torch.floor(w_frac)
    w_lo = rd.w_active.expand_as(w_frac)
    w_hi = Wf * rd.w_active
    w = _clip(torch.floor(w_frac), w_lo, w_hi)
    w = _int_redistribute(w, rem, w_lo, w_hi, Wf[:, 0])
    valid = w.sum(1) == Wf[:, 0]
    n = _clip(torch.round(n_frac), zero, w) * rd.has_gpu
    return w, n, valid


def round_to_incumbent_reference(
    v: torch.Tensor, W: torch.Tensor, k: torch.Tensor, rd: RoundingData
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dense rounding kernel."""
    f64 = torch.float64
    v = v.to(f64)
    Wf = W.to(f64)[:, None]
    k_f = k.to(f64)
    inf = torch.tensor(float("inf"), dtype=f64, device=v.device)
    zero = torch.zeros((), dtype=f64, device=v.device)
    w, n, valid = _round_w_n(v, W, rd)
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


class _MoEPricer:
    """Exact objective of (w, n, y) rows with the row's w, n fixed and y
    varying: the price() of the reference's MoE rounding, over a batch of
    candidate y vectors per row. The linear costs are summed in device
    order, as the kernel sums them."""

    def __init__(self, w, n, W, k, rd: RoundingData):
        bp = rd.bprime
        self.rd = rd
        self.k_f = k.to(torch.float64)[:, None]  # (B, 1)
        self.g_k = (rd.g_raw / k.to(torch.float64)[:, None])[:, None, :]
        self.base_res = (bp * w - bp * n * rd.ram_minus_n)[:, None, :]
        self.bn = (bp * n)[:, None, :]
        self.wcap = torch.minimum(w, W.to(torch.float64)[:, None])[:, None, :]
        self.n_tol = (n + 1e-9)[:, None, :]
        self.aw_bn = (rd.a * w + rd.b_gpu * n)[:, None, :]
        self.half_fetch = (0.5 * (bp / rd.s_disk * w))[:, None, :]

    def __call__(self, Y: torch.Tensor) -> torch.Tensor:
        """(B, C) objectives of the candidate rows ``Y`` (B, C, M)."""
        rd = self.rd
        bp = rd.bprime
        zero = torch.zeros((), dtype=Y.dtype, device=Y.device)
        viol_ram = torch.clamp(self.base_res + rd.eb_ram * Y - rd.ram_rhs, min=0.0)
        s_ram = torch.ceil(viol_ram / bp - 1e-9)
        ok = (s_ram <= self.wcap).all(-1)
        viol_vram = torch.clamp(
            torch.maximum(self.bn + rd.eb_vram * Y - rd.cuda_rhs,
                          self.bn + rd.eb_metal * Y - rd.metal_rhs),
            min=0.0,
        )
        viol_vram = torch.where(torch.isfinite(viol_vram), viol_vram, zero)
        t = torch.ceil(viol_vram / bp - 1e-9)
        ok &= (t <= self.n_tol).all(-1)
        pen_cost = rd.pen_set * s_ram + rd.pen_vram * t
        lin = (self.aw_bn + pen_cost) + self.g_k * Y
        C = (lin + rd.busy_const + self.half_fetch).amax(-1)
        total = lin[..., 0]
        for j in range(1, lin.shape[-1]):
            total = total + lin[..., j]
        return torch.where(ok, (self.k_f - 1.0) * C + total, float("inf"))


def price_fixed_assignment(rd: RoundingData, k, W, w, n, y) -> torch.Tensor:
    """Exact linear MILP objective (float64) of fixed integer MoE assignments:
    no rounding, no repair, no expert moves; +inf where an assignment is
    infeasible (``sum w != W``, some ``w < 1``, ``sum y != E``, a RAM slack
    above ``min(w, W)`` or a VRAM slack above ``n``). The total objective is
    this plus ``obj_const``.

    ``w``, ``n``, ``y`` are (M,) for one assignment, or (P, M) for P of them
    with ``k`` and ``W`` scalars or (P,). Returns a () or (P,) tensor on
    ``rd``'s device: the pricing kernel (B14, ``round_moe_kernel.cu``) on a
    CUDA device, the plain version (:func:`price_fixed_assignment_reference`)
    on the CPU."""
    dev = rd.a.device
    f64 = torch.float64
    w, n, y = (torch.as_tensor(x, dtype=f64, device=dev) for x in (w, n, y))
    single = w.dim() == 1
    w, n, y = (x.reshape(-1, rd.a.shape[0]) for x in (w, n, y))
    P = w.shape[0]
    k = torch.as_tensor(k, dtype=f64, device=dev).reshape(-1).expand(P)
    W = torch.as_tensor(W, dtype=f64, device=dev).reshape(-1).expand(P)
    if kernels.on_cuda(w, rd.a):
        obj = _price_fixed_kernel(rd, k, W, w, n, y)
    else:
        obj = price_fixed_assignment_reference(rd, k, W, w, n, y)
    return obj[0] if single else obj


def price_fixed_assignment_reference(rd: RoundingData, k, W, w, n, y) -> torch.Tensor:
    """Plain PyTorch version of the fixed-assignment pricing kernel: the
    :class:`_MoEPricer` price of each (P,) row's own y."""
    valid = (w.sum(1) == W) & (w >= 1.0).all(1) & (y.sum(1) == rd.E)
    obj = _MoEPricer(w, n, W, k, rd)(y[:, None, :])[:, 0]
    return torch.where(valid, obj, float("inf"))


def _price_fixed_kernel(rd: RoundingData, k, W, w, n, y):
    from ..kernels.build import library

    P, M = w.shape
    packed = pack_rounding_data(rd)
    obj = torch.empty(P, dtype=torch.float64, device=w.device)
    if P == 0:
        return obj
    # Held until the launch: a temporary freed inside the argument list
    # could hand its memory to the next one.
    ins = [t.contiguous() for t in (w, n, y, W, k, packed, rd.E.to(torch.float64))]
    err = library("round_moe").dtk_price_fixed_f64(
        *[kernels.ptr(t) for t in ins], M, P, kernels.ptr(obj), PRICE_FIXED_THREADS,
        kernels.stream_handle(w.device),
    )
    kernels.check(err, "price_fixed")
    kernels.LAUNCHES["price_fixed"] += 1
    return obj


def round_moe_reference(
    v: torch.Tensor,
    W: torch.Tensor,
    k: torch.Tensor,
    rd: RoundingData,
    y_steps: Optional[int] = None,
    moves: int = MOE_LOCAL_MOVES,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the MoE rounding kernel: (obj, w, n, y)."""
    f64 = torch.float64
    M = rd.a.shape[0]
    dev = v.device
    v = v.to(f64)
    B = v.shape[0]
    E = rd.E.to(f64)
    inf = torch.tensor(float("inf"), dtype=f64, device=dev)
    zero = torch.zeros((), dtype=f64, device=dev)
    w, n, valid = _round_w_n(v, W, rd)
    price = _MoEPricer(w, n, W, k, rd)
    eye = torch.eye(M, dtype=f64, device=dev)
    rows = torch.arange(B, device=dev)

    y_frac = v[:, 2 * M : 3 * M]
    if y_steps is None:
        y_rem = y_frac - torch.floor(y_frac)
        y = _clip(torch.floor(y_frac), zero, E)
        y = _int_redistribute(y, y_rem, zero, E, E.expand(B))
    else:
        # Greedy exact-priced repair toward sum(y) == E: add the unit where
        # the objective grows least, or remove where it shrinks most.
        y = _clip(torch.round(y_frac), zero, E)
        for _ in range(y_steps):
            d = E - y.sum(1)
            if not bool((d != 0).any()):
                break  # nothing moves once every row sums to E
            add = torch.where(y < E, price(y[:, None, :] + eye), inf).argmin(1)
            sub = torch.where(y > 0, price(y[:, None, :] - eye), inf).argmin(1)
            step = torch.where(d > 0, 1.0, torch.where(d < 0, -1.0, 0.0)).to(f64)
            idx = torch.where(d > 0, add, sub)
            y = y + step[:, None] * eye[idx]
    valid = valid & (y.sum(1) == E)

    # Expert moves: every (q, i, j) transfer of q experts from i to j.
    qs = torch.tensor(MOVE_QUANTA, dtype=f64, device=dev)
    diff = eye[None, :, :] - eye[:, None, :]  # (i, j, M) = e_j - e_i
    not_diag = ~torch.eye(M, dtype=torch.bool, device=dev)
    for _ in range(moves):
        cand = y[:, None, None, None, :] + qs[None, :, None, None, None] * diff[None, None]
        feas = (
            (y[:, None, :, None] >= qs[None, :, None, None])
            & (y[:, None, None, :] + qs[None, :, None, None] <= E)
            & not_diag
        )
        cand = cand.reshape(B, -1, M)
        objs = torch.where(feas.reshape(B, -1), price(cand), inf)
        flat = objs.argmin(1)
        better = objs[rows, flat] < price(y[:, None, :])[:, 0] - 1e-12
        y = torch.where(better[:, None], cand[rows, flat], y)

    obj = torch.where(valid, price(y[:, None, :])[:, 0], inf)
    return obj, w, n, y


def _check_packed(packed: torch.Tensor, M: int) -> None:
    if packed.shape[-2:] != (PACKED_ROWS, M) or packed.dim() > 3 \
            or packed.dtype != torch.float64:
        raise ValueError(f"packed rounding data must be float64 ([R,] {PACKED_ROWS}, M)")


def _lane_name(name: str, packed: torch.Tensor) -> str:
    """The launch counter of a K2 launch: ``<name>_lanes`` when it carries
    more than one instance."""
    return f"{name}_lanes" if packed.dim() == 3 and packed.shape[0] > 1 else name


def _instance_index(inst, B: int):
    """The rows' instance indices as a contiguous int32 tensor (None: the
    kernel reads instance 0 for every row). Their range is the caller's to
    keep: a check here would read the device back in the middle of a
    round."""
    if inst is None:
        return None
    inst = inst.to(torch.int32).contiguous()
    if inst.shape != (B,):
        raise ValueError(f"inst must be ({B},), got {tuple(inst.shape)}")
    return inst


def _round_kernel(v, W, k, rd: RoundingData, packed=None, inst=None):
    from ..kernels.build import library

    if v.dim() != 2:
        raise ValueError(f"v must be (B, nf), got {tuple(v.shape)}")
    B = v.shape[0]
    M = rd.a.shape[-1]
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
    _check_packed(packed, M)
    inst = _instance_index(inst, B)
    obj = torch.empty(B, dtype=torch.float64, device=dev)
    w = torch.empty((B, M), dtype=torch.float64, device=dev)
    n = torch.empty((B, M), dtype=torch.float64, device=dev)
    if B == 0:
        return obj, w, n
    P = kernels.ptr
    lib = library("round")
    # Once a card and M it sets the shared-memory attribute rows of more
    # than 768 devices need; after that it checks and returns.
    kernels.check(lib.dtk_round_prepare(M), "round prepare")
    err = getattr(lib, fn_name)(
        P(v), v.shape[1], P(Wr), P(kr), P(packed), kernels.opt_ptr(inst),
        PACKED_ROWS * M, M, B, P(obj), P(w), P(n), kernels.stream_handle(dev),
    )
    kernels.check(err, "round_incumbent")
    kernels.LAUNCHES[_lane_name("round_incumbent", packed)] += 1
    return obj, w, n


def moe_table_workspace(lib, M: int, B: int, dev):
    """The global workspace of the MoE kernel's delta tables, or None when
    a block's shared memory holds a row's arrays and its table (every M up
    to 668 on an H100)."""
    nbytes = int(lib.dtk_round_moe_tab_bytes(M, B))
    if nbytes < 0:
        kernels.check(-nbytes, "round_moe")
    return torch.empty(nbytes, dtype=torch.uint8, device=dev) if nbytes else None


def _round_moe_kernel(v, W, k, rd: RoundingData, packed, y_steps, moves, inst=None):
    from ..kernels.build import library

    if v.dim() != 2:
        raise ValueError(f"v must be (B, nf), got {tuple(v.shape)}")
    B = v.shape[0]
    M = rd.a.shape[-1]
    if v.shape[1] < 3 * M:
        raise ValueError(f"v has {v.shape[1]} columns, fewer than 3M = {3 * M}")
    if v.dtype == torch.float32:
        fn_name = "dtk_round_moe_f32"
    elif v.dtype == torch.float64:
        fn_name = "dtk_round_moe_f64"
    else:
        raise TypeError(f"rounding kernel takes float32 or float64 v, got {v.dtype}")
    if y_steps is not None and y_steps < 0:
        raise ValueError("y_steps must be >= 0")
    v = v.contiguous()
    dev = v.device
    Wr = W.to(torch.float64).contiguous()
    kr = k.to(torch.float64).contiguous()
    if Wr.shape != (B,) or kr.shape != (B,):
        raise ValueError("W and k must be (B,)")
    if packed is None:
        packed = pack_rounding_data(rd)
    _check_packed(packed, M)
    inst = _instance_index(inst, B)
    # Held until the launch: a temporary freed inside the argument list could
    # hand its memory to the next one.
    E = rd.E.to(torch.float64).reshape(-1).contiguous()
    obj = torch.empty(B, dtype=torch.float64, device=dev)
    w = torch.empty((B, M), dtype=torch.float64, device=dev)
    n = torch.empty((B, M), dtype=torch.float64, device=dev)
    y = torch.empty((B, M), dtype=torch.float64, device=dev)
    if B == 0:
        return obj, w, n, y
    lib = library("round_moe")
    tab = moe_table_workspace(lib, M, B, dev)
    P = kernels.ptr
    err = getattr(lib, fn_name)(
        P(v), v.shape[1], P(Wr), P(kr), P(packed), P(E), kernels.opt_ptr(inst), M, B,
        -1 if y_steps is None else int(y_steps), int(moves),
        P(obj), P(w), P(n), P(y), kernels.opt_ptr(tab), 0 if tab is None else tab.numel(),
        MOE_THREADS, kernels.stream_handle(dev),
    )
    kernels.check(err, "round_moe")
    kernels.LAUNCHES[_lane_name("round_moe", packed)] += 1
    return obj, w, n, y
