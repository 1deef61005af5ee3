"""Row-partitioned PDHG across a device mesh, and the mixed-precision entry
with the per-element float64 re-solve: the port of ``distilp_tpu/ops/meshlp.py``.

:func:`sharded_pdhg` (kernel K6b on CUDA tensors) splits the rows of A over
the S shards of a :class:`~distilp_torch.parallel.devices.Mesh`. Each shard
holds an ``(m/S, n)`` block of A and the matching slices of b, of the
row equilibration and step vectors and of the dual iterate; the column data,
the primal iterate and every restart scalar are replicated, so every shard
takes the same branch every step. The cross-row reductions close over the
mesh with the collectives of :mod:`distilp_torch.parallel.collectives` at the
points where the reference's ``_pdhg_single(axis_name=...)`` puts its
``psum``/``pmax`` (``distilp_tpu/ops/pdhg.py:164-175``): the column partials
A_blk'(row_s y_blk) of every step and of the column 1-norms, the dual half of
the weighted residual, the non-finite verdict, max|b_s|, the convergence
test's primal residual and b_s'y, and the float64 certificate's A'y and b'y.

``m`` is padded up to a multiple of S with all-zero rows: the step guards
give them step 0 and dual 0, and they add nothing to any product or to the
certificate, so padding is exact. Warm states stay in the original
full-array coordinates: ``y`` is sliced into row blocks on entry and the
final duals all-gathered in mesh order on exit, so a warm state never carries
a shard count.

A per-element A (MoE nodes: the reference's ``A.ndim == 3``, sharded as
``P(None, axis, None)``) comes as an :class:`~distilp_torch.ops.pdhg.ElemA`,
each element's values on one union structure, or as a dense (B, m, n) A
gathered onto ``sparsity=`` or its union pattern. :func:`row_blocks` splits
the structure by row block (each block's own structure and the places of
its nonzeros among the full structure's; the search builds them once per
sweep), and each call takes every shard's values with one
``index_select``: no dense node A and no per-call transpose. The kernel's per-element entry walks each block's
structure with each element's values, as K5's per-element entry does.

On CUDA tensors ``kernels/csrc/pdhg_sharded_kernel.cu`` runs by one of two
routes (:func:`kernel_route`). When every shard lies on one device (a
virtual mesh), each slice of at most BMAX elements is one cooperative launch
of the fused entry: shard s on its own group of the card's blocks, the step
loop inside the kernel, each collective a read of the shards' parts in shard
order between grid syncs. When the shards span devices, the step is cut at
its collectives into phases, each one cooperative launch on one shard,
sequenced here with the collectives of :mod:`~distilp_torch.parallel.
collectives` between them. On CPU tensors :func:`sharded_pdhg_reference`
runs the plain version, a loop over the shards inside each step with the
collectives as fixed-order sums. :func:`pdhg_solve_batch_sharded` with one
shard is the plain K5 call, bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from .. import kernels
from ..parallel.collectives import AllReduce, all_gather, allreduce_reference
from ..parallel.devices import Mesh, shard_mesh
from .ipm import (
    TRACE_COLS,
    IPMResult,
    IPMSparsity,
    LPBatch,
    _bmv,
    _bmvT,
    _full_f32_matmul,
    chunking,
    ipm_sparsity,
)
from .pdhg import (
    BMAX,
    DEFAULT_RESTART_TOL,
    PDHG_DEFAULT_CHUNK,
    ElemA,
    _default_tol_pdhg,
    cast_batch,
    elem_a,
    pdhg_solve_batch,
    resolve_pdhg_dtype,
)
from ..obs.compile_ledger import instrument as _instrument

# The kernel's phases (pdhg_sharded_kernel.cu), its pointer and int slots.
(P_SETUP_A, P_SETUP_B, P_RES, P_RESW, P_INIT, P_STEP, P_COMMIT, P_STATS, P_DECIDE,
 P_EPI1, P_EPI2) = range(11)
N_PTR = 37
J_ARG = 7
N_INT = 9
N_SQ = 3


def pad_rows_to(m: int, shards: int) -> int:
    """Rows after padding ``m`` up to a multiple of ``shards``."""
    if shards < 1:
        raise ValueError(f"mesh_shards must be >= 1 (got {shards})")
    return int(-(-m // shards) * shards)


def _pad_axis(x: torch.Tensor, target: int, axis: int) -> torch.Tensor:
    """Zero-pad ``x`` along ``axis`` to length ``target`` (exact rows)."""
    pad = target - x.shape[axis]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], axis)


def kernel_route(mesh: Mesh, cuda: bool) -> str:
    """The route of a sharded solve: ``"plain"`` on CPU tensors, ``"fused"``
    when every shard of ``mesh`` lies on one device (one cooperative launch
    per slice holds them all), ``"sequenced"`` when the shards span devices
    (a launch per phase per shard, the collectives between them)."""
    if not cuda:
        return "plain"
    return "fused" if len(set(mesh.devices)) == 1 else "sequenced"


def group_blocks(G: int, S: int, max_shards: int) -> int:
    """Blocks of each shard's group when a fused launch splits the card's
    ``G`` co-resident blocks over ``S`` shards; raises when S > G or S is
    more than the launch holds (``max_shards``, the library's)."""
    if S > max_shards:
        raise ValueError(f"the fused route takes at most {max_shards} shards on one device; "
                         f"got {S}")
    if S > G:
        raise ValueError(f"{S} shards on one device need at least {S} co-resident blocks; "
                         f"the fused launch has {G}")
    return G // S


def sharded_pdhg(
    batch: LPBatch,
    mesh_shards,
    iters: int,
    tol,
    restart_tol,
    warm=None,
    skip: Optional[torch.Tensor] = None,
    chunk: int = PDHG_DEFAULT_CHUNK,
    trace: bool = False,
    replicas: Optional[list] = None,
    sparsity: Optional[IPMSparsity] = None,
    blocks: Optional["RowBlocks"] = None,
    _sequenced: bool = False,
) -> IPMResult:
    """Row-shard one LP batch over ``mesh_shards`` (a shard count resolved
    with :func:`shard_mesh` on the batch's device type, or a :class:`Mesh`)
    and solve it. ``batch.A`` is one shared (m, n) A, an :class:`ElemA`, or
    a dense per-element (B, m, n) A gathered onto ``sparsity`` (which must
    hold every nonzero) or onto the union of its elements' patterns.
    ``blocks`` is the per-element structure's :func:`row_blocks` for this
    shard count (built here when None), or for a shared A its
    :func:`dense_blocks` in the batch's dtype (held by the caller, so no
    call pads, slices or transposes A). Returns the
    unsharded engine's :class:`IPMResult` contract, every array in full
    coordinates on shard 0's device. ``replicas`` (a list) receives each
    shard's own copy of the result (the kernel routes compute the
    replicated values once per shard). ``_sequenced`` (for the card check
    only) runs the sequenced route on CUDA tensors at the fused route's
    per-shard grid, where the two agree bit for bit."""
    A = batch.A
    if isinstance(A, torch.Tensor) and A.dim() == 3:
        A = elem_a(A, sparsity)
    elif sparsity is not None:
        raise ValueError("sparsity= goes with a dense per-element (B, m, n) A")
    if isinstance(A, ElemA):
        batch = LPBatch(A, *(t.to(A.values.dtype) for t in batch[1:]))
        a_tensors = [A.values]
    elif A.dim() != 2:
        raise ValueError(f"A must be (m, n), (B, m, n) or ElemA, got {tuple(A.shape)}")
    else:
        a_tensors = [A]
    mesh = (mesh_shards if isinstance(mesh_shards, Mesh)
            else shard_mesh(mesh_shards, a_tensors[0].device))
    m = batch.b.shape[1]
    A_b, b_b, wv, wy_b, wok = shard_rows(batch, mesh.size, warm, blocks)
    tensors = a_tensors + list(batch[1:]) + ([] if warm is None else list(warm)) + [skip]
    if kernels.on_cuda(*tensors):
        if mesh.devices[0].type != "cuda":
            raise ValueError(f"CUDA tensors on a mesh of {mesh.devices[0].type} devices")
        At_b = blocks.At if isinstance(blocks, DenseBlocks) else None
        outs = _sharded_kernel(A_b, b_b, batch, wv, wy_b, wok, skip, mesh, iters,
                               float(tol), float(restart_tol), chunk, trace, m, _sequenced,
                               At_b)
    else:
        res = sharded_pdhg_reference(A_b, b_b, batch.c, batch.l, batch.u, iters, tol,
                                     restart_tol, wv=wv, wy=wy_b, wok=wok, skip=skip,
                                     chunk=chunk, trace=trace)
        outs = [res._replace(y_dual=res.y_dual[:, :m])] * mesh.size
    if replicas is not None:
        replicas[:] = outs
    return outs[0]


sharded_pdhg = _instrument("ops.meshlp.sharded_pdhg", sharded_pdhg)


class RowBlocks(NamedTuple):
    """A per-element A's union structure split into the row blocks of S
    shards (rows padded to a multiple of S: a padded row is an empty row of
    its block): block s's own structure (ms, n) and the places of its
    nonzeros among the full structure's (column order), so that
    ``values.index_select(1, take[s])`` are its values."""

    sparsity: Tuple[IPMSparsity, ...]
    take: Tuple[torch.Tensor, ...]  # (nnz_s,) int64 each


def row_blocks(sparsity: IPMSparsity, shards: int) -> RowBlocks:
    """The row blocks of ``sparsity`` on ``shards`` shards (on the
    structure's device)."""
    m, n = sparsity.m, sparsity.n
    ms = pad_rows_to(m, shards) // shards
    rows = sparsity.src // n  # each nonzero's row, in column order
    cols = sparsity.src % n
    blocks, take = [], []
    for s in range(shards):
        sel = torch.nonzero((rows >= s * ms) & (rows < (s + 1) * ms)).flatten()
        pattern = torch.zeros((ms, n), dtype=torch.bool, device=sparsity.src.device)
        pattern[rows[sel] - s * ms, cols[sel]] = True
        blocks.append(ipm_sparsity(pattern))
        take.append(sel)
    return RowBlocks(tuple(blocks), tuple(take))


class DenseBlocks(NamedTuple):
    """One shared (m, n) A's row blocks on S shards (rows padded with zeros
    to a multiple of S), each (ms, n) and its (n, ms) transpose, contiguous,
    in one dtype: what K6b's shared entry reads."""

    A: Tuple[torch.Tensor, ...]
    At: Tuple[torch.Tensor, ...]


def dense_blocks(A: torch.Tensor, shards: int, dtype=None) -> DenseBlocks:
    """The :class:`DenseBlocks` of ``A`` on ``shards`` shards in ``dtype``
    (None: A's own)."""
    A = A if dtype is None else A.to(dtype)
    m_pad = pad_rows_to(A.shape[0], shards)
    ms = m_pad // shards
    A_p = _pad_axis(A, m_pad, 0)
    blk = tuple(A_p[s * ms:(s + 1) * ms].contiguous() for s in range(shards))
    return DenseBlocks(blk, tuple(b.t().contiguous() for b in blk))


def gather_rows_reference(y_blocks, m: int) -> torch.Tensor:
    """Plain version of the loop's gather (``bnb_loop_kernel.cu``'s
    ``bnb_gather_kernel``): the shards' dual blocks, each (R, ms), side by
    side in mesh order with the padded rows dropped, (R, m)."""
    return torch.cat(list(y_blocks), 1)[:, :m]


def shard_rows(batch: LPBatch, shards: int, warm=None, blocks=None):
    """The row blocks of a batch on ``shards`` shards, rows padded with
    zeros to a multiple of the shard count: ``(A blocks, b blocks (B, ms),
    warm v, warm y blocks, warm verdict)``, the warm parts None without a
    warm state. A shared A gives (ms, n) blocks (``blocks``' when it holds
    them, :class:`DenseBlocks`); an :class:`ElemA` gives an ``ElemA`` per
    block, its values taken on the block's structure (``blocks``, else
    :func:`row_blocks` of the batch's). The verdict (ok and every component
    finite) is judged on the caller's full arrays, before any cast."""
    A = batch.A
    m = batch.b.shape[1]
    m_pad = pad_rows_to(m, shards)
    ms = m_pad // shards
    rows = [slice(s * ms, (s + 1) * ms) for s in range(shards)]
    b_p = _pad_axis(batch.b, m_pad, 1)
    if isinstance(A, ElemA):
        dtype = A.values.dtype
        if blocks is None:
            blocks = row_blocks(A.sparsity, shards)
        if len(blocks.take) != shards:
            raise ValueError(f"row blocks of {len(blocks.take)} shards for {shards}")
        A_b = [ElemA(A.values.index_select(1, t), sp)
               for t, sp in zip(blocks.take, blocks.sparsity)]
    elif isinstance(blocks, DenseBlocks):
        dtype = A.dtype
        if len(blocks.A) != shards or blocks.A[0].shape != (ms, A.shape[1]) or \
                blocks.A[0].dtype != dtype:
            raise ValueError(f"dense blocks {len(blocks.A)} x {tuple(blocks.A[0].shape)} "
                             f"{blocks.A[0].dtype} for {shards} shards of ({ms}, "
                             f"{A.shape[1]}) {dtype}")
        A_b = list(blocks.A)
    else:
        dtype = A.dtype
        A_p = _pad_axis(A, m_pad, 0)
        A_b = [A_p[r] for r in rows]
    wv = wy_b = wok = None
    if warm is not None:
        wok = (warm.ok.to(torch.bool) & torch.isfinite(warm.v).all(1)
               & torch.isfinite(warm.y).all(1) & torch.isfinite(warm.z).all(1)
               & torch.isfinite(warm.f).all(1))
        wv = warm.v.to(dtype)
        wy = _pad_axis(warm.y.to(dtype), m_pad, 1)
        wy_b = [wy[:, r] for r in rows]
    return A_b, [b_p[:, r] for r in rows], wv, wy_b, wok


def sharded_pdhg_reference(A_b, b_b, c, l, u, iters: int, tol, restart_tol, wv=None,
                           wy=None, wok=None, skip=None, chunk: int = PDHG_DEFAULT_CHUNK,
                           trace: bool = False) -> IPMResult:
    """Plain version of the row-sharded PDHG: the shards' row blocks ``A_b``
    (each (ms, n), or per element (B, ms, n) or an :class:`ElemA`, made
    dense here) and ``b_b`` (each (B, ms)), the replicated column data;
    ``wy`` the warm dual's row blocks and ``wok`` (B,) the caller's verdict
    on the warm state. A loop over the shards inside each step (a
    per-element A through batched products over the blocks); the
    collectives are fixed-order sums (and maxima) over the shards' parts.
    ``y_dual`` comes back over every padded row."""
    A_b = [a.dense() if isinstance(a, ElemA) else a for a in A_b]
    with _full_f32_matmul():
        return _sharded_reference(A_b, b_b, c, l, u, iters, tol, restart_tol, wv, wy, wok,
                                  skip, chunk, trace)


def _sharded_reference(A_b, b_b, c, l, u, iters, tol, restart_tol, wv, wy, wok, skip,
                       chunk, trace) -> IPMResult:
    S = len(A_b)
    dtype, dev = c.dtype, c.device
    B, n = c.shape
    inf = float("inf")
    shards = range(S)

    def psum(parts):
        return allreduce_reference(parts, "sum")

    def pmax(parts):
        return allreduce_reference(parts, "max")

    per_element = A_b[0].dim() == 3
    if per_element:
        mv, mvT = _bmv, _bmvT
    else:
        def mv(M, x):
            return x @ M.T

        def mvT(M, y):
            return y @ M

    r_raw = u - l
    active = r_raw > 0
    col_s = torch.where(active, r_raw, 1.0)
    cs_a = torch.where(active, r_raw, 0.0)
    act = active.to(dtype)
    cm = torch.where(active, c * col_s, 0.0)
    absA = [A.abs() for A in A_b]
    row_s = [1.0 / torch.clamp(torch.stack([(a[e] if per_element else a).mul(cs_a[e]).amax(1)
                                            for e in range(B)]), min=1e-12) for a in absA]
    b_s = [(b_b[s] - mv(A_b[s], l)) * row_s[s] for s in shards]

    def opA(s, x):
        return row_s[s] * mv(A_b[s], cs_a * x)

    def opAT(y):
        return cs_a * psum([mvT(A_b[s], row_s[s] * y[s]) for s in shards])

    row_1n = [row_s[s] * mv(absA[s], cs_a) for s in shards]
    col_1n = cs_a * psum([mvT(absA[s], row_s[s]) for s in shards])
    tau = torch.where(col_1n > 1e-12, 0.9 / torch.clamp(col_1n, min=1e-12), 0.0)
    tau = torch.where(active, tau, 0.0)
    sigma = [torch.where(r1 > 1e-12, 0.9 / torch.clamp(r1, min=1e-12), 0.0) for r1 in row_1n]

    x0 = torch.full((B, n), 0.5, dtype=dtype, device=dev)
    y0 = [torch.zeros_like(bs) for bs in b_s]
    b_scale = 1.0 + pmax([bs.abs().amax(1) for bs in b_s])
    c_scale = 1.0 + cm.abs().amax(1)

    def T(x, y):
        x_new = torch.clamp(x - tau * (cm - opAT(y)), 0.0, 1.0)
        z = 2.0 * x_new - x
        return x_new, [y[s] + sigma[s] * (b_s[s] - opA(s, z)) for s in shards]

    def weighted_res(dx, dy):
        qx = (torch.where(tau > 0, dx * dx, 0.0) / torch.clamp(tau, min=1e-30)).sum(1)
        qy = psum([(torch.where(sigma[s] > 0, dy[s] * dy[s], 0.0)
                    / torch.clamp(sigma[s], min=1e-30)).sum(1) for s in shards])
        return torch.sqrt(qx + qy)

    def res_of(x, y):
        Tx, Ty = T(x, y)
        return weighted_res(Tx - x, [Ty[s] - y[s] for s in shards])

    def conv_stats(x, y):
        rp_n = pmax([(b_s[s] - opA(s, x)).abs().amax(1) for s in shards])
        obj = (cm * x).sum(1)
        red = cm - opAT(y)
        neg = torch.clamp(red, max=0.0)
        lag = psum([(b_s[s] * y[s]).sum(1) for s in shards]) + (act * neg).sum(1)
        gap = (obj - lag).abs()
        conv = (rp_n < tol * b_scale) & (gap < tol * (b_scale + c_scale + obj.abs()))
        rd_n = (red - neg * act).abs().amax(1)
        return conv, rp_n, rd_n, gap / (b_scale + c_scale)

    if wv is not None:
        x_w = (torch.minimum(torch.maximum(wv, l), u) - l) / col_s
        x_w = torch.clamp(x_w, 0.0, 1.0)
        y_w = [wy[s] / row_s[s] for s in shards]
        res_w = res_of(x_w, y_w)
        res_c = res_of(x0, y0)
        res_w = torch.where(torch.isfinite(res_w), res_w, inf)
        use_w = wok.to(torch.bool) & (res_w <= res_c)
        x0 = torch.where(use_w[:, None], x_w, x0)
        y0 = [torch.where(use_w[:, None], y_w[s], y0[s]) for s in shards]

    done = torch.zeros(B, dtype=torch.bool, device=dev)
    if skip is not None:
        done = done | skip.to(torch.bool)
    x, xa, y, ya = x0, x0, list(y0), list(y0)
    res_a = torch.clamp(res_of(x0, y0), min=1e-30)
    t = torch.zeros(B, dtype=torch.int32, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)

    def step(x, y, xa, ya, res_a, t, it, live):
        Tx, Ty = T(x, y)
        res = weighted_res(Tx - x, [Ty[s] - y[s] for s in shards])
        w_new = ((t.to(dtype) + 1.0) / (t.to(dtype) + 2.0))[:, None]
        x_h = w_new * Tx + (1.0 - w_new) * xa
        y_h = [w_new * Ty[s] + (1.0 - w_new) * ya[s] for s in shards]
        restart = (res <= restart_tol * res_a) | (res > res_a)
        r2 = restart[:, None]
        x_n = torch.where(r2, Tx, x_h)
        y_n = [torch.where(r2, Ty[s], y_h[s]) for s in shards]
        xa_n = torch.where(r2, Tx, xa)
        ya_n = [torch.where(r2, Ty[s], ya[s]) for s in shards]
        res_a_n = torch.where(restart, res, res_a)
        t_n = torch.where(restart, torch.zeros_like(t), t + 1)
        # The verdict is mesh-global: the primal half is replicated, the dual
        # halves' non-finite flags close with a pmax.
        bad_y = pmax([(~torch.isfinite(y_n[s])).any(1).to(dtype) for s in shards])
        finite = (torch.isfinite(x_n).all(1) & (bad_y < 0.5))[:, None]
        x_n = torch.where(finite, x_n, x)
        y_n = [torch.where(finite, y_n[s], y[s]) for s in shards]
        lv = live[:, None]
        return (
            torch.where(lv, x_n, x), [torch.where(lv, y_n[s], y[s]) for s in shards],
            torch.where(lv, xa_n, xa), [torch.where(lv, ya_n[s], ya[s]) for s in shards],
            torch.where(live, res_a_n, res_a), torch.where(live, t_n, t),
            it + live.to(torch.int32),
        )

    chunk, n_chunks = chunking(iters, chunk)
    tbuf = torch.zeros((B, n_chunks, TRACE_COLS), dtype=dtype, device=dev) if trace else None
    n_restart = torch.zeros(B, dtype=torch.int32, device=dev)
    for ci in range(n_chunks):
        if bool(done.all()):
            break
        live = ~done
        t_start = t
        for _ in range(chunk):
            x, y, xa, ya, res_a, t, it = step(x, y, xa, ya, res_a, t, it, live)
        conv, rp_n, rd_n, gap_n = conv_stats(x, y)
        done = done | (live & conv)
        if trace:
            n_restart = n_restart + (live & (t != t_start + chunk)).to(torch.int32)
            row = torch.stack([it.to(dtype), rp_n, rd_n, gap_n, n_restart.to(dtype),
                               torch.ones_like(gap_n)], 1)
            tbuf[:, ci] = torch.where(live[:, None], row, tbuf[:, ci])

    rp = pmax([(b_s[s] - opA(s, x)).abs().amax(1) for s in shards])
    red32 = cm - opAT(y)
    rd = red32 - torch.clamp(red32, max=0.0) * act
    mu = ((cm * x).sum(1) - (
        psum([(b_s[s] * y[s]).sum(1) for s in shards])
        + (act * torch.clamp(red32, max=0.0)).sum(1)
    )).abs() / (b_scale + c_scale)
    y = [y[s] * row_s[s] for s in shards]  # back to the original-units dual

    # The float64 certificate: each shard's rows add their share of A'y and
    # of b̂'y, closed by float64 psums.
    f64 = torch.float64
    l64 = l.to(f64)
    y64 = [ys.to(f64) for ys in y]
    A64 = [A.to(f64) for A in A_b]
    reduced = c.to(f64) - psum([mvT(A64[s], y64[s]) for s in shards])
    bh_y = psum([((b_b[s].to(f64) - mv(A64[s], l64)) * y64[s]).sum(1) for s in shards])
    r64 = (r_raw * act).to(f64)
    bound = bh_y + (r64 * torch.clamp(reduced, max=0.0)).sum(1)
    bound = torch.where(torch.isfinite(bound), bound, -inf)
    shift = (c.to(f64) * l64).sum(1)
    v = l + torch.where(active, col_s * x, 0.0)
    red_orig = reduced.to(dtype)
    return IPMResult(
        v=v,
        bound=bound + shift,
        obj=(c * v).sum(1),
        rp_norm=rp,
        rd_norm=rd.abs().amax(1),
        mu=mu,
        converged=done,
        reduced=reduced,
        y_dual=torch.cat(y, 1),
        z_dual=torch.where(active, torch.clamp(red_orig, min=0.0), 0.0),
        f_dual=torch.where(active, torch.clamp(-red_orig, min=0.0), 0.0),
        iters_run=it,
        trace_buf=tbuf,
    )


class _Shard:
    """One shard's buffers and launch arguments for a slice of at most BMAX
    elements (the kernel's per-element state lives in ``ws``). ``A_blk`` is
    the shard's (ms, n) block, or for the per-element entry its elements'
    values (B, nnz_s) with ``index`` the block's structure."""

    def __init__(self, lib, dev, A_blk, index, b_blk, c, l, u, wv, wy, wok, skip, G: int,
                 chunk: int, n_chunks: int, trace_rows: int, tol: float, rt: float,
                 out: IPMResult, y_out: torch.Tensor, shape: str, At_blk=None):
        f64 = A_blk.dtype == torch.float64
        B, n = c.shape
        ms = b_blk.shape[1]
        kw = dict(dtype=A_blk.dtype, device=dev)
        self.elem = elem = index is not None
        if elem:
            self.fn = lib.dtk_pdhgs_elem_f64 if f64 else lib.dtk_pdhgs_elem_f32
            a_held, nnz = [A_blk, index], A_blk.shape[1]
        else:
            self.fn = lib.dtk_pdhgs_f64 if f64 else lib.dtk_pdhgs_f32
            At = A_blk.t().contiguous() if At_blk is None else At_blk
            a_held, nnz = [A_blk, At], 0
        self.dev, self.shape = dev, shape
        self.held = [*a_held, *(t.contiguous() for t in (b_blk, c, l, u)),
                     None if wv is None else wv.contiguous(),
                     None if wy is None else wy.contiguous(),
                     None if wok is None else wok.to(torch.uint8).contiguous(),
                     None if skip is None else skip.to(torch.uint8).contiguous()]
        self.ws = torch.empty(int(lib.dtk_pdhgs_ws_bytes(B, ms, n, G, int(f64))),
                              dtype=torch.uint8, device=dev)
        self.part, self.g = torch.zeros((B, n), **kw), torch.zeros((B, n), **kw)
        d64 = dict(dtype=torch.float64, device=dev)
        self.part64, self.g64 = torch.zeros((B, n), **d64), torch.zeros((B, n), **d64)
        self.sq, self.sqg = torch.zeros((B, N_SQ), **kw), torch.zeros((B, N_SQ), **kw)
        self.srp, self.srpg = torch.zeros(B, **kw), torch.zeros(B, **kw)
        self.sby, self.sbyg = torch.zeros(B, **kw), torch.zeros(B, **kw)
        self.s64, self.s64g = torch.zeros(B, **d64), torch.zeros(B, **d64)
        self.done = torch.zeros(B, dtype=torch.int32, device=dev)
        ptrs = self.held[:10] + [self.ws, self.part, self.g, self.part64, self.g64, self.sq,
                                 self.sqg, self.srp, self.srpg, self.sby, self.sbyg,
                                 self.s64, self.s64g, self.done,
                                 out.v, out.bound, out.obj, out.rp_norm, out.rd_norm, out.mu,
                                 out.converged, out.reduced, y_out, out.z_dual, out.f_dual,
                                 out.iters_run, out.trace_buf]
        assert len(ptrs) == N_PTR
        self.ptrs = [None if t is None else t.data_ptr() for t in ptrs]
        self.ints = [B, ms, n, chunk, n_chunks, trace_rows, G, 0, nnz]
        self.P = (ctypes.c_void_p * N_PTR)(*self.ptrs)
        self.I = (ctypes.c_int * N_INT)(*self.ints)
        self.D = (ctypes.c_double * 2)(tol, rt)
        self.stream = kernels.stream_handle(dev)

    def run(self, phase: int, arg: int = 0) -> None:
        self.I[J_ARG] = arg
        err = self.fn(phase, self.P, self.I, self.D, self.ws.numel(), self.stream)
        kernels.check(err, "pdhg_sharded")
        self.count()

    def count(self) -> None:
        if self.elem:
            kernels.count_launch("pdhg_sharded_elem", self.shape)
        else:
            kernels.count_launch("pdhg_sharded", self.shape)


def _sharded_kernel(A_b, b_b, batch, wv, wy_b, wok, skip, mesh: Mesh, iters, tol, rt,
                    chunk, trace, m, sequenced: bool = False, At_b=None) -> List[IPMResult]:
    from ..kernels.build import library

    elem = isinstance(A_b[0], ElemA)
    dtype = A_b[0].values.dtype if elem else A_b[0].dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"sharded pdhg kernel takes float32 or float64 A, got {dtype}")
    c, l, u = batch.c, batch.l, batch.u
    B, n = c.shape
    ms = b_b[0].shape[1]
    if elem:
        for a in A_b:
            sp = a.sparsity
            if (sp.m, sp.n) != (ms, n) or tuple(a.values.shape) != (B, sp.nnz):
                raise ValueError(f"per-element block: structure ({sp.m}, {sp.n}) and values "
                                 f"{tuple(a.values.shape)} do not match B={B}, (ms, n) = "
                                 f"{(ms, n)}")
    for name, t, shape in (("b", batch.b, (B, m)), ("c", c, (B, n)),
                           ("l", l, (B, n)), ("u", u, (B, n))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if skip is not None and tuple(skip.shape) != (B,):
        raise ValueError(f"skip: expected shape {(B,)}, got {tuple(skip.shape)}")
    lib = library("pdhg_sharded")
    f64 = dtype == torch.float64
    S = mesh.size
    route = "sequenced" if sequenced else kernel_route(mesh, True)
    # One grid for every shard, so every shard reduces its replicated
    # partials in the same order: the fused route's group of the card's
    # blocks (the card check runs the sequenced route on it too), else the
    # smallest of the devices' grids.
    if route == "fused" or sequenced:
        G = fused_group(mesh.devices[0], S, f64, elem)
    else:
        grid_of = lib.dtk_pdhgs_elem_grid if elem else lib.dtk_pdhgs_grid
        grids = []
        for dev in dict.fromkeys(mesh.devices):
            with torch.cuda.device(dev):
                grids.append(int(grid_of(int(f64))))
        if min(grids) < 1:
            raise RuntimeError(f"pdhg_sharded grid query failed with cudaError {-min(grids)}")
        G = min(grids)
    chunk, n_chunks = chunking(iters, chunk)
    trace_rows = n_chunks if trace else 0
    outs = []
    for dev in mesh.devices:
        kw = dict(dtype=dtype, device=dev)
        outs.append(IPMResult(
            v=torch.empty((B, n), **kw),
            bound=torch.empty(B, dtype=torch.float64, device=dev),
            obj=torch.empty(B, **kw), rp_norm=torch.empty(B, **kw),
            rd_norm=torch.empty(B, **kw), mu=torch.empty(B, **kw),
            converged=torch.empty(B, dtype=torch.bool, device=dev),
            reduced=torch.empty((B, n), dtype=torch.float64, device=dev),
            y_dual=torch.empty((B, ms), **kw),
            z_dual=torch.empty((B, n), **kw), f_dual=torch.empty((B, n), **kw),
            iters_run=torch.empty(B, dtype=torch.int32, device=dev),
            trace_buf=torch.zeros((B, n_chunks, TRACE_COLS), **kw) if trace else None,
        ))
    if B:
        shape = f"B={B} m={m} n={n} S={S}" + (
            f" per-element A nnz={sum(a.sparsity.nnz for a in A_b)}" if elem else "") + (
            f" route={route}")
        multi = len(set(mesh.devices)) > 1
        for e0 in range(0, B, BMAX):
            e1 = min(B, e0 + BMAX)
            sl = slice(e0, e1)

            def cut(t):
                return None if t is None else t[sl]

            shards = []
            for s, dev in enumerate(mesh.devices):
                on = (lambda t, d=dev: None if t is None else t.to(d))
                o = outs[s]
                if elem:
                    a_blk = on(A_b[s].values[sl]).contiguous()
                    index = on(A_b[s].sparsity.index)
                else:
                    a_blk, index = on(A_b[s]).contiguous(), None
                shards.append(_Shard(
                    lib, dev, a_blk, index, on(b_b[s][sl]), on(c[sl]),
                    on(l[sl]), on(u[sl]), on(cut(wv)),
                    None if wy_b is None else on(wy_b[s][sl]), on(cut(wok)), on(cut(skip)),
                    G, chunk, n_chunks, trace_rows, tol, rt,
                    IPMResult(*(None if t is None else t[sl] for t in o)),
                    o.y_dual[sl], shape, None if At_b is None or elem else on(At_b[s])))
            if route == "fused":
                sh0 = shards[0]
                k6b_launch(sh0.elem, f64, [sh.ptrs for sh in shards],
                           [sh.ints for sh in shards], [sh.ws.numel() for sh in shards],
                           tol, rt, wv is not None, sh0.stream)
                sh0.count()
            else:
                _run_phases(shards, mesh, n_chunks, chunk, wv is not None, multi)
    # The dual blocks are the only row-sharded output: gather them in mesh
    # order and drop the padding, as the reference's tiled all_gather.
    ys = all_gather([o.y_dual for o in outs], mesh, dim=1)
    return [o._replace(y_dual=y[:, :m]) for o, y in zip(outs, ys)]


def fused_group(dev, S: int, f64: bool, elem: bool) -> int:
    """Blocks of each shard's group in a fused launch of S shards on
    ``dev``: :func:`group_blocks` of the card's grid for the entry (the
    library asks the card once a device and entry, then keeps it; no
    launch queries)."""
    from ..kernels.build import library

    lib = library("pdhg_sharded")
    with torch.cuda.device(dev):
        G = int(lib.dtk_pdhgs_fused_grid(int(f64), int(elem)))
    if G < 1:
        raise RuntimeError(f"pdhg_sharded grid query failed with cudaError {-G}")
    return group_blocks(G, S, int(lib.dtk_pdhgs_fused_max_shards()))


def k6b_launch(elem: bool, f64: bool, ptrs, ints, ws_lens, tol: float, rt: float, warm: bool,
               stream) -> None:
    """One cooperative launch of K6b's fused route for a slice of every shard
    of one card, on buffers the caller owns: ``ptrs[s]`` shard s's N_PTR
    pointer slots (ints or None: the collectives' receive slots are never
    read on this route), ``ints[s]`` its N_INT ints (one B, chunking and
    group size for every shard), ``ws_lens[s]`` its workspace's bytes. The
    wrapper (:func:`sharded_pdhg`) and the loop's plan
    (``solver/device_loop.py``, inside a graph capture) both launch through
    here; neither the query of the grid nor an attribute is made here."""
    from ..kernels.build import library

    lib = library("pdhg_sharded")
    S = len(ptrs)
    if elem:
        fn = lib.dtk_pdhgs_elem_fused_f64 if f64 else lib.dtk_pdhgs_elem_fused_f32
    else:
        fn = lib.dtk_pdhgs_fused_f64 if f64 else lib.dtk_pdhgs_fused_f32
    P = (ctypes.c_void_p * (S * N_PTR))(*(v for row in ptrs for v in row))
    I = (ctypes.c_int * (S * N_INT))(*(v for row in ints for v in row))
    D = (ctypes.c_double * 2)(tol, rt)
    ws = (ctypes.c_long * S)(*ws_lens)
    err = fn(S, P, I, D, ws, int(warm), stream)
    kernels.check(err, "pdhg_sharded fused")


def _run_phases(shards: List[_Shard], mesh: Mesh, n_chunks: int, chunk: int, warm: bool,
                multi: bool) -> None:
    """The host's sequence of phases and collectives for one slice."""
    def each(phase, arg=0):
        for sh in shards:
            if multi:
                with torch.cuda.device(sh.dev):
                    sh.run(phase, arg)
            else:
                sh.run(phase, arg)

    def plan(src, dst, op):
        return AllReduce([getattr(sh, src) for sh in shards],
                         [getattr(sh, dst) for sh in shards], mesh, op)

    psum_part = plan("part", "g", "sum")
    psum_sq = plan("sq", "sqg", "sum")
    pmax_rp = plan("srp", "srpg", "max")
    psum_by = plan("sby", "sbyg", "sum")
    each(P_SETUP_A)
    pmax_rp()
    psum_part()
    each(P_SETUP_B)
    psum_part()
    if warm:
        each(P_RES, 1)
        psum_sq()
        each(P_RESW)
        psum_part()
    each(P_RES, 0)
    psum_sq()
    each(P_INIT)
    psum_part()
    done = shards[0].done
    if not bool(done.all()):
        for ci in range(n_chunks):
            for _ in range(chunk):
                each(P_STEP)
                psum_sq()
                each(P_COMMIT)
                psum_part()
            each(P_STATS, 0)
            pmax_rp()
            psum_by()
            each(P_DECIDE, ci)
            if bool(done.all()):
                break
    each(P_STATS, 1)
    pmax_rp()
    psum_by()
    each(P_EPI1)
    plan("part64", "g64", "sum")()
    plan("s64", "s64g", "sum")()
    each(P_EPI2)


def pdhg_solve_batch_sharded(
    batch: LPBatch,
    tol: Optional[float] = None,
    restart_tol: Optional[float] = None,
    warm=None,
    skip: Optional[torch.Tensor] = None,
    mesh_shards=1,
    iters: int = 1000,
    chunk: int = PDHG_DEFAULT_CHUNK,
    trace: bool = False,
    dtype: Optional[str] = None,
) -> IPMResult:
    """The sharded sibling of :func:`~distilp_torch.ops.pdhg.pdhg_solve_batch`
    (``dtype`` the iterate precision, None = the batch's own; ``batch.A``
    shared, per element dense or an :class:`ElemA`). One shard is the plain
    K5 call, bit for bit."""
    if not isinstance(mesh_shards, Mesh) and int(mesh_shards) < 1:
        raise ValueError(f"mesh_shards must be >= 1 (got {mesh_shards})")
    if not isinstance(mesh_shards, Mesh) and int(mesh_shards) == 1:
        return pdhg_solve_batch(batch, iters=iters, tol=tol, restart_tol=restart_tol,
                                warm=warm, skip=skip, chunk=chunk, trace=trace, dtype=dtype)
    dt = resolve_pdhg_dtype(dtype)
    if dt is not None:
        batch = cast_batch(batch, dt)
    a_dtype = batch.A.values.dtype if isinstance(batch.A, ElemA) else batch.A.dtype
    tol_v = _default_tol_pdhg(a_dtype) if tol is None else tol
    rt_v = DEFAULT_RESTART_TOL if restart_tol is None else restart_tol
    return sharded_pdhg(batch, mesh_shards, iters, tol_v, rt_v, warm=warm, skip=skip,
                        chunk=chunk, trace=trace)


def pdhg_solve_batch_mp(
    batch: LPBatch,
    mesh_shards=1,
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
    """The (optionally sharded) PDHG at ``dtype`` iterate precision with the
    float64 fallback: an element whose run comes back not converged or with
    a non-finite bound is re-solved in float64 and spliced back element by
    element. ``fallback_report`` (a dict) receives ``n_fallback``, the
    number of elements re-solved."""
    resolve_pdhg_dtype(dtype)  # validate the spelling first, as the reference
    kw = dict(iters=iters, tol=tol, restart_tol=restart_tol, warm=warm,
              skip=skip, chunk=chunk, trace=trace, mesh_shards=mesh_shards)
    res = pdhg_solve_batch_sharded(batch, dtype=dtype, **kw)
    n_bad = 0
    if f64_fallback and dtype != "f64":
        bad = ~res.converged | ~torch.isfinite(res.bound)
        n_bad = int(bad.sum())
        if n_bad:
            res64 = pdhg_solve_batch_sharded(batch, dtype="f64", **kw)

            def splice(a, a64):
                if a is None:  # no trace buffer
                    return None
                sel = bad.reshape((-1,) + (1,) * (a.dim() - 1))
                return torch.where(sel, a64.to(a.dtype), a)

            res = IPMResult(*(splice(a, a64) for a, a64 in zip(res, res64)))
    if fallback_report is not None:
        fallback_report["n_fallback"] = n_bad
    return res
