"""Batched restarted Halpern PDHG for box-constrained LPs: the matrix-free
fleet-scale sibling of :mod:`distilp_torch.ops.ipm`.

Same problem family, batch layout (:class:`~distilp_torch.ops.ipm.LPBatch`,
one shared (m, n) A or one A per element) and result contract
(:class:`~distilp_torch.ops.ipm.IPMResult`)::

    min c'v   s.t.  A v = b,   l <= v <= u

Every step is two operator applications (A x and A'y) and no factorization,
so memory is the matrix once plus O(B (m + n)) vectors: this is the engine
``lp_backend='auto'`` picks at fleet scale (M >= 128 devices), where the
IPM's per-node m x m normal matrices stop fitting.

Per element, as ``distilp_tpu/ops/pdhg.py::_pdhg_single`` computes it: box
width column equilibration (x in [0, 1]^n) and an inf-norm row
equilibration, both kept as vectors; diagonal Pock-Chambolle steps from the
two |A| reductions; a best-of-two warm entry (the projected warm point or the
cold start, whichever has the smaller weighted fixed-point residual); then
per step the PDHG operator T(x, y), the Halpern average toward the restart
anchor, the adaptive restart, a non-finite rollback; convergence (primal
feasibility and relative duality gap) tested once per ``chunk`` steps with a
batch-wide early exit. The exit certificate is the float64 Lagrangian bound
``b'y + sum_j r_j min(0, (c - A'y)_j)`` (+ c'l), valid for any dual.

:func:`pdhg_solve_batch` launches a hand-written CUDA kernel on CUDA tensors
and runs :func:`pdhg_solve_batch_reference`, the plain PyTorch version, on
CPU tensors. The kernel reads A only through its sparse structure, as
values on it (:class:`ElemA`): a per-element A (the reference's
``a_axis = 0``: MoE nodes, batch lanes) as each element's values on one
union structure, one shared A as its values with a batch stride of 0; never
a dense (B, m, n) stack or a dense (m, n) A. It has two routes, chosen by
:func:`pdhg_route` from the element's shape: the cluster route
(``kernels/csrc/pdhg_cluster_kernel.cu``, one thread-block cluster per
element holding its LP in shared memory, all elements in one launch) for
every element a cluster holds, the grid route (``kernels/csrc/
pdhg_kernel.cu``, one cooperative launch over the card per batch of up to
:data:`BMAX` elements) for larger ones. ``trace=True`` records the
convergence trace of ``ops/ipm.py`` (:data:`TRACE_COLS`), with the
cumulative restart-chunk count in its restarts column.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .ipm import (
    TRACE_COLS,
    IPMResult,
    IPMSparsity,
    LPBatch,
    _bmv,
    _bmvT,
    _full_f32_matmul,
    check_sparsity,
    chunking,
    ipm_sparsity,
)
from ..obs.compile_ledger import instrument as _instrument

# Convergence-test granularity (steps per chunk).
PDHG_DEFAULT_CHUNK = 32
# Sufficient-decay factor of the adaptive restart.
DEFAULT_RESTART_TOL = 0.2
# Iterate-precision knob values ('f32' iterates with the f64 certificate;
# 'f64' is the soundness rung an uncertified f32 run escalates to).
PDHG_DTYPES = ("f32", "f64")
# Elements per launch of the grid route; a larger batch is solved in slices
# (elements are independent: a finished element is frozen whatever the
# others do). The cluster route takes any batch in one launch.
BMAX = 16

# The cluster route's layout (kernels/csrc/pdhg_cluster_kernel.cu): cluster
# sizes, an H100 block's dynamic shared memory, the head of every CTA's
# shared memory, its column and row vectors, and the length past which a row
# or column gets a warp of its own.
CLUSTER_SIZES = (1, 2, 4, 8)
SMEM_LIMIT = 232448
HEAD_BYTES = 2048
N_COLV = N_ROWV = 7
LONG_NNZ = 32
# Room pdhg_route leaves in a CTA for the ownership plan's imbalance: a
# contiguous split is even to within one row's or column's bytes.
PLAN_SLACK = 16384


def _default_tol_pdhg(dtype) -> float:
    """First-order exit tolerance: 1e-7 relative in float64 (two decades
    below the tightest certified gap), the shared 1e-5 floor in float32."""
    return 1e-7 if dtype == torch.float64 else 1e-5


def resolve_pdhg_dtype(name):
    """'f32'/'f64' (or None = keep the batch dtype) -> torch dtype or None."""
    if name is None:
        return None
    if name == "f32":
        return torch.float32
    if name == "f64":
        return torch.float64
    raise ValueError(f"unknown pdhg_dtype {name!r}; expected one of {PDHG_DTYPES}")


class ElemA(NamedTuple):
    """A per-element A as each element's values on one shared sparse
    structure (for a batch, the union of the elements' patterns): element
    e's A has ``values[e, q]`` at the q-th nonzero of ``sparsity`` in column
    order, so ``A.reshape(B, m*n)[:, sparsity.src] == values``. Values with
    a batch stride of 0 (:func:`shared_a`) are one A shared by the batch."""

    values: torch.Tensor  # (B, nnz)
    sparsity: IPMSparsity

    @property
    def shared(self) -> bool:
        """One A for every element: the values' batch stride is 0."""
        return self.values.stride(0) == 0

    def dense(self) -> torch.Tensor:
        """The (B, m, n) A these values describe."""
        sp = self.sparsity
        B = self.values.shape[0]
        flat = self.values.new_zeros((B, sp.m * sp.n))
        flat[:, sp.src] = self.values
        return flat.reshape(B, sp.m, sp.n)

    def matrix(self) -> torch.Tensor:
        """The one (m, n) A of a shared ElemA."""
        sp = self.sparsity
        flat = self.values.new_zeros(sp.m * sp.n)
        flat[sp.src] = self.values.as_strided((sp.nnz,), (1,))
        return flat.reshape(sp.m, sp.n)


def elem_a(A: torch.Tensor, sparsity: Optional[IPMSparsity] = None) -> ElemA:
    """A dense (B, m, n) A as :class:`ElemA`: its values gathered on
    ``sparsity`` (which must hold every nonzero of every element,
    :func:`~distilp_torch.ops.ipm.check_sparsity`), or on the union of its
    elements' patterns."""
    if sparsity is None:
        sparsity = ipm_sparsity((A != 0).any(0))
    else:
        check_sparsity(A, sparsity)
    B, m, n = A.shape
    return ElemA(A.reshape(B, m * n)[:, sparsity.src], sparsity)


def shared_a(A: torch.Tensor, B: int, sparsity: Optional[IPMSparsity] = None) -> ElemA:
    """One (m, n) A for a batch of B as :class:`ElemA`: its values gathered
    once on ``sparsity`` (which must hold every nonzero of A), or on A's own
    pattern, with a batch stride of 0."""
    if sparsity is None:
        sparsity = ipm_sparsity(A != 0)
    else:
        check_sparsity(A, sparsity)
    vals = A.reshape(-1)[sparsity.src]
    return ElemA(vals.as_strided((B, sparsity.nnz), (0, 1)), sparsity)


def cast_values(values: torch.Tensor, dtype) -> torch.Tensor:
    """An :class:`ElemA`'s values in ``dtype``, shared ones kept shared."""
    if values.dtype == dtype:
        return values
    if values.stride(0) == 0:
        return values.as_strided((values.shape[1],), (1,)).to(dtype).as_strided(
            tuple(values.shape), (0, 1))
    return values.to(dtype)


def cast_batch(batch: LPBatch, dtype) -> LPBatch:
    """``batch`` in ``dtype``, an :class:`ElemA`'s values included."""
    A = batch.A
    A = A._replace(values=cast_values(A.values, dtype)) if isinstance(A, ElemA) \
        else A.to(dtype)
    return LPBatch(A, *(t.to(dtype) for t in batch[1:]))


def _al16(x: int) -> int:
    return (x + 15) & ~15


def cluster_smem_bytes(m: int, n: int, nr: int, nc: int, zr: int, zc: int,
                       itemsize: int) -> int:
    """Shared-memory bytes of one CTA of the cluster route that owns nr rows
    (zr nonzeros) and nc columns (zc nonzeros) of an (m, n) element: the
    head, the column and row replicas, its part of the structure and values,
    its share of the vectors (the kernel's ``smem_bytes``)."""
    t = itemsize
    return (HEAD_BYTES + _al16(t * n) + _al16(t * m) + _al16(4 * (nr + 1)) + _al16(4 * zr)
            + _al16(4 * (nc + 1)) + _al16(4 * zc) + _al16(t * zr) + _al16(t * zc)
            + N_COLV * _al16(t * nc) + N_ROWV * _al16(t * nr))


def pdhg_route(m: int, n: int, nnz: int, dtype, c_max: int = CLUSTER_SIZES[-1]
               ) -> Tuple[str, int]:
    """K5's route for an (m, n) element with nnz nonzeros in ``dtype``:
    ``("cluster", C)`` with the least cluster size C <= ``c_max`` whose CTAs
    each hold an even share of the element's structure, values and vectors
    beside the replicas and the head, with :data:`PLAN_SLACK` to spare;
    ``("grid", 0)`` when none does."""
    t = torch.empty((), dtype=dtype).element_size()
    local = 4 * (m + n + 2) + 2 * nnz * (4 + t) + t * (N_COLV * n + N_ROWV * m)
    fixed = HEAD_BYTES + _al16(t * n) + _al16(t * m) + PLAN_SLACK
    for C in CLUSTER_SIZES:
        if C <= c_max and fixed + -(-local // C) <= SMEM_LIMIT:
            return "cluster", C
    return "grid", 0


class ClusterPlan(NamedTuple):
    """Which rows and columns each of the C CTAs of an element's cluster
    owns (contiguous blocks balanced by bytes), its long rows and columns
    (more than :data:`LONG_NNZ` nonzeros; local indices), each CTA's
    (rows, columns, row nonzeros, column nonzeros) and shared-memory bytes,
    and the kernel's copy of the plan on the structure's device."""

    C: int
    rows: Tuple[int, ...]  # C + 1 starts
    cols: Tuple[int, ...]
    long_rows: Tuple[Tuple[int, ...], ...]
    long_cols: Tuple[Tuple[int, ...], ...]
    counts: Tuple[Tuple[int, int, int, int], ...]
    bytes: Tuple[int, ...]
    smem: int  # the largest CTA's bytes: the launch's dynamic shared memory
    buf: torch.Tensor  # int32: rows, cols, long-row and long-column starts, the lists


def _split(weights: np.ndarray, C: int) -> np.ndarray:
    """C + 1 starts of C contiguous blocks of ``weights`` whose sums are as
    even as whole items allow: each cut at the prefix nearest its share."""
    cum = np.concatenate([[0], np.cumsum(weights)])
    starts = [0]
    for k in range(1, C):
        target = cum[-1] * k / C
        i = int(np.searchsorted(cum, target))
        if i > 0 and (i == len(cum) or target - cum[i - 1] <= cum[i] - target):
            i -= 1
        starts.append(max(starts[-1], i))
    starts.append(len(weights))
    return np.asarray(starts, dtype=np.int64)


def _make_plan(sp: IPMSparsity, itemsize: int, C: int) -> ClusterPlan:
    parts = sp.parts()
    a_ptr = parts["a_ptr"].cpu().numpy().astype(np.int64)
    t_ptr = parts["t_ptr"].cpu().numpy().astype(np.int64)
    rlen, clen = np.diff(a_ptr), np.diff(t_ptr)
    t = itemsize
    rows = _split((4 + t) * rlen + 4 + N_ROWV * t, C)
    cols = _split((4 + t) * clen + 4 + N_COLV * t, C)
    long_r = [np.nonzero(rlen[rows[r]:rows[r + 1]] > LONG_NNZ)[0] for r in range(C)]
    long_c = [np.nonzero(clen[cols[r]:cols[r + 1]] > LONG_NNZ)[0] for r in range(C)]
    counts = tuple((int(rows[r + 1] - rows[r]), int(cols[r + 1] - cols[r]),
                    int(a_ptr[rows[r + 1]] - a_ptr[rows[r]]),
                    int(t_ptr[cols[r + 1]] - t_ptr[cols[r]])) for r in range(C))
    nbytes = tuple(cluster_smem_bytes(sp.m, sp.n, *cnt, t) for cnt in counts)
    lrp = np.cumsum([0] + [len(x) for x in long_r])
    lcp = np.cumsum([0] + [len(x) for x in long_c])
    buf = np.concatenate([rows, cols, lrp, lcp, *long_r, *long_c]).astype(np.int32)
    return ClusterPlan(C=C, rows=tuple(int(v) for v in rows), cols=tuple(int(v) for v in cols),
                       long_rows=tuple(tuple(int(v) for v in x) for x in long_r),
                       long_cols=tuple(tuple(int(v) for v in x) for x in long_c),
                       counts=counts, bytes=nbytes, smem=max(nbytes),
                       buf=torch.as_tensor(buf, device=sp.index.device))


# id(structure's index tensor) -> (a weak reference to it, {(itemsize, C): plan})
_PLANS: Dict[int, Tuple[weakref.ref, Dict[Tuple[int, int], ClusterPlan]]] = {}


def cluster_plan(sp: IPMSparsity, itemsize: int, C: int) -> ClusterPlan:
    """The cluster route's ownership plan of structure ``sp`` for C CTAs,
    built once per structure, itemsize and C (one read of its row and
    column pointers to the host) and kept while the structure lives."""
    key = id(sp.index)
    hit = _PLANS.get(key)
    if hit is None or hit[0]() is not sp.index:
        hit = (weakref.ref(sp.index), {})
        _PLANS[key] = hit
        weakref.finalize(sp.index, _PLANS.pop, key, None)
    plans = hit[1]
    if (itemsize, C) not in plans:
        plans[(itemsize, C)] = _make_plan(sp, itemsize, C)
    return plans[(itemsize, C)]


def kernel_route(sp: IPMSparsity, dtype, c_max: int = CLUSTER_SIZES[-1]):
    """(route, C, plan) of a launch on structure ``sp``: :func:`pdhg_route`'s
    choice, with the grid route where the exact plan of its cluster size
    does not fit a CTA's shared memory after all."""
    route, C = pdhg_route(sp.m, sp.n, sp.nnz, dtype, c_max)
    if route == "cluster":
        plan = cluster_plan(sp, torch.empty((), dtype=dtype).element_size(), C)
        if plan.smem <= SMEM_LIMIT:
            return route, C, plan
    return "grid", 0, None


# (device, float64) -> the largest cluster size the card schedules; the grid
# route's blocks a launch.
_CLUSTER_MAX: Dict[Tuple[str, bool], int] = {}
_GRID: Dict[Tuple[str, bool], int] = {}


def _dev_key(dev: torch.device, f64: bool) -> Tuple[str, bool]:
    return (str(torch.device(dev)), f64)


def _cluster_max(dev: torch.device, f64: bool) -> int:
    """The largest cluster size the card schedules, the cluster kernel
    prepared for a full block of shared memory on ``dev`` (once a device and
    dtype: no launch sets an attribute, so a launch can be captured)."""
    from ..kernels.build import library

    key = _dev_key(dev, f64)
    if key not in _CLUSTER_MAX:
        lib = library("pdhg_cluster")
        with torch.cuda.device(dev):
            c_max = int(lib.dtk_pdhgc_max_cluster(int(f64)))
            kernels.check(lib.dtk_pdhgc_prepare(int(f64)), "pdhg_cluster prepare")
        _CLUSTER_MAX[key] = c_max
    return _CLUSTER_MAX[key]


def _grid_blocks(dev: torch.device, f64: bool) -> int:
    """The grid route's blocks a launch on ``dev`` (its occupancy query, once
    a device and dtype: no launch queries, so a launch can be captured)."""
    from ..kernels.build import library

    key = _dev_key(dev, f64)
    if key not in _GRID:
        with torch.cuda.device(dev):
            G = int(library("pdhg").dtk_pdhg_grid(int(f64)))
        if G < 1:
            raise RuntimeError(f"pdhg grid route: the grid cannot be sized (cudaError {-G})")
        _GRID[key] = G
    return _GRID[key]


def check_cluster_layout(plan: ClusterPlan, m: int, n: int, f64: bool) -> None:
    """Raises unless every CTA's bytes in ``plan`` are the kernel's layout."""
    from ..kernels.build import library

    lib = library("pdhg_cluster")
    for r, cnt in enumerate(plan.counts):
        if int(lib.dtk_pdhgc_smem_bytes(m, n, *cnt, int(f64))) != plan.bytes[r]:
            raise RuntimeError("the cluster plan's bytes differ from the kernel's layout")


def route_ws_sizes(route: str, B: int, m: int, n: int, f64: bool) -> Tuple[int, ...]:
    """Workspace bytes of each launch of one K5 call of B elements on
    ``route``: the grid route's slices of :data:`BMAX`, whose workspaces a
    call lays end to end (the call's workspace is their sum); none for the
    cluster route."""
    if route != "grid":
        return ()
    from ..kernels.build import library

    lib = library("pdhg")
    sizes = tuple(int(lib.dtk_pdhg_ws_bytes(min(BMAX, B - s), m, n, int(f64)))
                  for s in range(0, B, BMAX))
    if not all(sizes):
        raise RuntimeError("pdhg grid route: the workspace cannot be sized on this card")
    return sizes


def _row(t: Optional[torch.Tensor], s: int):
    """A pointer to row ``s`` of ``t`` (None stays None): no view is made."""
    if t is None:
        return ctypes.c_void_p(None)
    return ctypes.c_void_p(t.data_ptr() + s * t.stride(0) * t.element_size())


def k5_launch(route: str, C: int, buf, smem: int, ws, ws_sizes: Tuple[int, ...], G: int,
              index: torch.Tensor, nnz: int, vals, vstride: int, b, c, l, u, wv, wy, wok,
              skip, out: IPMResult, chunk: int, n_chunks: int, tol: float,
              restart_tol: float, stream) -> int:
    """K5 on given buffers (the wrapper's, or a loop plan's inside a CUDA
    graph capture): no allocation, no query, no torch operation. ``route``,
    ``C``, the ownership plan's ``buf`` and ``smem`` (cluster route), the
    workspace ``ws`` and its slices' bytes ``ws_sizes``
    (:func:`route_ws_sizes`) and the grid ``G`` of :func:`_grid_blocks`
    (grid route: one launch a slice of :data:`BMAX` elements, as the wrapper
    has always cut them) were fixed before; ``index`` and ``nnz`` are A's
    structure (``IPMSparsity.index``, ``.nnz``). ``wv``, ``wy``, ``wok``,
    ``skip`` may be None. Writes ``out``'s fields (bound, converged,
    reduced and iters_run may lie in another result than the
    iteration-dtype fields) and returns the launches made."""
    from ..kernels.build import library

    B, n = c.shape
    m = b.shape[1]
    f64 = vals.dtype == torch.float64
    P, O = kernels.ptr, kernels.opt_ptr
    if route == "cluster":
        lib = library("pdhg_cluster")
        fn = lib.dtk_pdhgc_f64 if f64 else lib.dtk_pdhgc_f32
        err = fn(
            P(index), P(buf), C, nnz, P(vals), vstride,
            P(b), P(c), P(l), P(u), O(wv), O(wy), O(wok), O(skip),
            B, m, n, chunk, n_chunks, float(tol), float(restart_tol), LONG_NNZ, smem,
            P(out.v), P(out.bound), P(out.obj), P(out.rp_norm), P(out.rd_norm), P(out.mu),
            P(out.converged), P(out.reduced), P(out.y_dual), P(out.z_dual), P(out.f_dual),
            P(out.iters_run), O(out.trace_buf), n_chunks, stream,
        )
        kernels.check(err, "pdhg")
        return 1
    lib = library("pdhg")
    fn = lib.dtk_pdhg_elem_f64 if f64 else lib.dtk_pdhg_elem_f32
    off = 0
    for i, s in enumerate(range(0, B, BMAX)):
        nb = min(BMAX, B - s)
        err = fn(
            P(index), nnz, _row(vals, s), vstride,
            _row(b, s), _row(c, s), _row(l, s), _row(u, s),
            _row(wv, s), _row(wy, s), _row(wok, s), _row(skip, s),
            nb, m, n, chunk, n_chunks, float(tol), float(restart_tol),
            ctypes.c_void_p(ws.data_ptr() + off), ws_sizes[i], G,
            _row(out.v, s), _row(out.bound, s), _row(out.obj, s),
            _row(out.rp_norm, s), _row(out.rd_norm, s), _row(out.mu, s),
            _row(out.converged, s), _row(out.reduced, s), _row(out.y_dual, s),
            _row(out.z_dual, s), _row(out.f_dual, s), _row(out.iters_run, s),
            _row(out.trace_buf, s), n_chunks, stream,
        )
        kernels.check(err, "pdhg")
        off += ws_sizes[i]
    return len(ws_sizes)


def k5_name(shared: bool, trace: bool = False) -> str:
    """The launch counter of a K5 launch."""
    return "pdhg_trace" if trace else ("pdhg" if shared else "pdhg_elem")


def k5_shape(B: int, m: int, n: int, shared: bool, nnz: int, route: str, C: int) -> str:
    """The shape key a K5 launch counts under (``kernels.SHAPES``)."""
    return f"B={B} m={m} n={n}" + ("" if shared else f" per-element A nnz={nnz}") \
        + f" route={route}{C or ''}"


class PDHGWarmState(NamedTuple):
    """Warm-start iterate in ORIGINAL coordinates, field for field the port's
    ``IPMWarmState``: either engine's iterates seed the other. ``z``/``f``
    ride along (PDHG re-derives its dual geometry from ``v``/``y``) and are
    emitted on exit as the reduced-cost sign split; ``ok`` (B,) bool gates
    each element, and any non-finite component starts it cold."""

    v: torch.Tensor  # (B, n)
    y: torch.Tensor  # (B, m)
    z: torch.Tensor  # (B, n)
    f: torch.Tensor  # (B, n)
    ok: torch.Tensor  # (B,) bool


def pdhg_solve_batch(
    batch: LPBatch,
    iters: int = 1000,
    tol: Optional[float] = None,
    restart_tol: Optional[float] = None,
    warm=None,
    skip: Optional[torch.Tensor] = None,
    chunk: int = PDHG_DEFAULT_CHUNK,
    trace: bool = False,
    dtype: Optional[str] = None,
    sparsity: Optional[IPMSparsity] = None,
) -> IPMResult:
    """Solve a batch of boxed LPs: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors.

    ``batch.A`` is one shared (m, n) A, a per-element (B, m, n) A, or an
    :class:`ElemA` (each element's values on one sparse structure). A dense
    A is gathered onto ``sparsity`` (it must hold every nonzero; a pattern
    that misses one raises) or onto A's own pattern (for a per-element A
    the union of its elements' patterns): always on CUDA, where the kernel
    reads A only through its structure; on the CPU a shared A given without
    ``sparsity`` goes to the plain version as it is. ``iters`` is the
    per-element budget, spent ``chunk`` steps at
    a time with a batch-wide convergence test between chunks;
    ``restart_tol`` is the restart's sufficient-decay factor; ``warm`` takes
    a :class:`PDHGWarmState` or an ``IPMWarmState``. ``trace`` records one
    convergence-trace row per executed chunk into ``trace_buf``. ``dtype``
    ('f32'/'f64', None = the batch's own) sets the iteration precision: the
    batch is cast on entry, the certificate stays the float64 bound either
    way.
    """
    A = batch.A
    if isinstance(A, torch.Tensor) and A.dim() == 3:
        A = elem_a(A, sparsity)
    elif isinstance(A, torch.Tensor) and A.dim() == 2 and (
            sparsity is not None or A.device.type == "cuda"):
        A = shared_a(A, batch.b.shape[0], sparsity)
    elif sparsity is not None:
        raise ValueError("sparsity= goes with a dense (m, n) or (B, m, n) A")
    dt = resolve_pdhg_dtype(dtype)
    if isinstance(A, ElemA):
        if dt is not None:
            A = A._replace(values=cast_values(A.values, dt))
        batch = LPBatch(A, *(t.to(A.values.dtype) for t in batch[1:]))
        a_dtype, a_tensors = A.values.dtype, [A.values]
    else:
        if A.dim() != 2:
            raise ValueError(f"A must be (m, n), (B, m, n) or ElemA, got {tuple(A.shape)}")
        if dt is not None and dt != A.dtype:
            batch = LPBatch(*(t.to(dt) for t in batch))
        a_dtype, a_tensors = batch.A.dtype, [batch.A]
    tol_v = _default_tol_pdhg(a_dtype) if tol is None else float(tol)
    rt_v = DEFAULT_RESTART_TOL if restart_tol is None else float(restart_tol)
    tensors = a_tensors + list(batch[1:]) + ([] if warm is None else list(warm)) + [skip]
    if kernels.on_cuda(*tensors):
        return _pdhg_kernel(batch, iters, tol_v, rt_v, warm, skip, chunk, trace)
    return pdhg_solve_batch_reference(batch, iters, tol_v, rt_v, warm, skip, chunk, trace)


pdhg_solve_batch = _instrument("ops.pdhg.pdhg_solve_batch", pdhg_solve_batch)


def pdhg_solve_batch_reference(
    batch: LPBatch,
    iters: int = 1000,
    tol: Optional[float] = None,
    restart_tol: Optional[float] = None,
    warm=None,
    skip: Optional[torch.Tensor] = None,
    chunk: int = PDHG_DEFAULT_CHUNK,
    trace: bool = False,
) -> IPMResult:
    """Plain PyTorch version of the PDHG kernel (batch axis written out).
    A per-element A (dense (B, m, n), or :class:`ElemA`, made dense here)
    goes through batched products; a shared :class:`ElemA` is made the one
    dense (m, n) A again."""
    if isinstance(batch.A, ElemA):
        A = batch.A
        batch = batch._replace(A=A.matrix() if A.shared else A.dense())
    tol = _default_tol_pdhg(batch.A.dtype) if tol is None else tol
    restart_tol = DEFAULT_RESTART_TOL if restart_tol is None else restart_tol
    with _full_f32_matmul():
        return _reference(batch, iters, tol, restart_tol, warm, skip, chunk, trace)


def _reference(batch, iters, tol, restart_tol, warm, skip, chunk, trace) -> IPMResult:
    A, b, c, l, u = batch
    dtype, dev = A.dtype, A.device
    B, n = c.shape
    m = b.shape[1]
    inf = float("inf")
    if A.dim() == 2:
        def mv(M, x):
            return x @ M.T

        def mvT(M, y):
            return y @ M
    else:
        mv, mvT = _bmv, _bmvT

    r_raw = u - l
    active = r_raw > 0
    b_hat = b - mv(A, l)
    col_s = torch.where(active, r_raw, 1.0)
    cs_a = torch.where(active, r_raw, 0.0)
    act = active.to(dtype)
    cm = torch.where(active, c * col_s, 0.0)
    absA = A.abs()
    # Row inf-norms of |A| diag(cs_a), one element at a time: never a
    # (B, m, n) scaled copy of a shared A.
    row_max = torch.stack([
        (absA if A.dim() == 2 else absA[e]).mul(cs_a[e]).amax(1) for e in range(B)
    ]) if B else torch.zeros((0, m), dtype=dtype, device=dev)
    row_s = 1.0 / torch.clamp(row_max, min=1e-12)
    b_s = b_hat * row_s

    def opA(x):
        return row_s * mv(A, cs_a * x)

    def opAT(y):
        return cs_a * mvT(A, row_s * y)

    row_1n = row_s * mv(absA, cs_a)
    col_1n = cs_a * mvT(absA, row_s)
    tau = torch.where(col_1n > 1e-12, 0.9 / torch.clamp(col_1n, min=1e-12), 0.0)
    tau = torch.where(active, tau, 0.0)
    sigma = torch.where(row_1n > 1e-12, 0.9 / torch.clamp(row_1n, min=1e-12), 0.0)

    x0 = torch.full((B, n), 0.5, dtype=dtype, device=dev)
    y0 = torch.zeros((B, m), dtype=dtype, device=dev)
    b_scale = 1.0 + b_s.abs().amax(1)
    c_scale = 1.0 + cm.abs().amax(1)

    def T(x, y):
        x_new = torch.clamp(x - tau * (cm - opAT(y)), 0.0, 1.0)
        y_new = y + sigma * (b_s - opA(2.0 * x_new - x))
        return x_new, y_new

    def weighted_res(dx, dy):
        qx = (torch.where(tau > 0, dx * dx, 0.0) / torch.clamp(tau, min=1e-30)).sum(1)
        qy = (torch.where(sigma > 0, dy * dy, 0.0) / torch.clamp(sigma, min=1e-30)).sum(1)
        return torch.sqrt(qx + qy)

    def res_of(x, y):
        Tx, Ty = T(x, y)
        return weighted_res(Tx - x, Ty - y)

    def conv_stats(x, y):
        """(converged, rp_norm, rd_norm, normalized gap) at (x, y)."""
        rp = b_s - opA(x)
        obj = (cm * x).sum(1)
        red = cm - opAT(y)
        neg = torch.clamp(red, max=0.0)
        lag = (b_s * y).sum(1) + (act * neg).sum(1)
        gap = (obj - lag).abs()
        rp_n = rp.abs().amax(1)
        conv = (rp_n < tol * b_scale) & (gap < tol * (b_scale + c_scale + obj.abs()))
        rd_n = (red - neg * act).abs().amax(1)
        return conv, rp_n, rd_n, gap / (b_scale + c_scale)

    if warm is not None:
        v_w, y_w, z_w, f_w, ok_w = warm
        fin = (
            ok_w.to(torch.bool)
            & torch.isfinite(v_w).all(1)
            & torch.isfinite(y_w).all(1)
            & torch.isfinite(z_w).all(1)
            & torch.isfinite(f_w).all(1)
        )
        x_w = (torch.minimum(torch.maximum(v_w.to(dtype), l), u) - l) / col_s
        x_w = torch.clamp(x_w, 0.0, 1.0)
        y_w = y_w.to(dtype) / row_s
        res_w = res_of(x_w, y_w)
        res_c = res_of(x0, y0)
        res_w = torch.where(torch.isfinite(res_w), res_w, inf)
        use_w = fin & (res_w <= res_c)
        x0 = torch.where(use_w[:, None], x_w, x0)
        y0 = torch.where(use_w[:, None], y_w, y0)

    done = torch.zeros(B, dtype=torch.bool, device=dev)
    if skip is not None:
        done = done | skip.to(torch.bool)
    x, y, xa, ya = x0, y0, x0, y0
    res_a = torch.clamp(res_of(x0, y0), min=1e-30)
    t = torch.zeros(B, dtype=torch.int32, device=dev)
    it = torch.zeros(B, dtype=torch.int32, device=dev)

    def step(x, y, xa, ya, res_a, t, it, live):
        Tx, Ty = T(x, y)
        res = weighted_res(Tx - x, Ty - y)
        t_f = t.to(dtype)
        w_new = ((t_f + 1.0) / (t_f + 2.0))[:, None]
        x_h = w_new * Tx + (1.0 - w_new) * xa
        y_h = w_new * Ty + (1.0 - w_new) * ya
        restart = (res <= restart_tol * res_a) | (res > res_a)
        r2 = restart[:, None]
        x_n = torch.where(r2, Tx, x_h)
        y_n = torch.where(r2, Ty, y_h)
        xa_n = torch.where(r2, Tx, xa)
        ya_n = torch.where(r2, Ty, ya)
        res_a_n = torch.where(restart, res, res_a)
        t_n = torch.where(restart, torch.zeros_like(t), t + 1)
        # A non-finite step keeps the previous iterate (anchor and counters
        # still move, as in the reference).
        finite = (torch.isfinite(x_n).all(1) & torch.isfinite(y_n).all(1))[:, None]
        x_n = torch.where(finite, x_n, x)
        y_n = torch.where(finite, y_n, y)
        # A finished element's whole state is frozen (the batched while
        # loop's per-element select).
        lv = live[:, None]
        return (
            torch.where(lv, x_n, x), torch.where(lv, y_n, y),
            torch.where(lv, xa_n, xa), torch.where(lv, ya_n, ya),
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
            # A live chunk without a restart advances t by exactly chunk.
            n_restart = n_restart + (live & (t != t_start + chunk)).to(torch.int32)
            row = torch.stack([it.to(dtype), rp_n, rd_n, gap_n, n_restart.to(dtype),
                               torch.ones_like(gap_n)], 1)
            tbuf[:, ci] = torch.where(live[:, None], row, tbuf[:, ci])

    # Final residuals (iteration dtype, scaled units; diagnostics only).
    rp = b_s - opA(x)
    red32 = cm - opAT(y)
    rd = red32 - torch.clamp(red32, max=0.0) * act
    mu = ((cm * x).sum(1) - (
        (b_s * y).sum(1) + (act * torch.clamp(red32, max=0.0)).sum(1)
    )).abs() / (b_scale + c_scale)
    y = y * row_s  # back to the original-units dual

    # Float64 Lagrangian bound with float64 accumulation over A.
    f64 = torch.float64
    A64 = A.to(f64)
    y64 = y.to(f64)
    r64 = (r_raw * act).to(f64)
    l64 = l.to(f64)
    c64 = c.to(f64)
    bh64 = b.to(f64) - mv(A64, l64)
    reduced = c64 - mvT(A64, y64)
    bound = (bh64 * y64).sum(1) + (r64 * torch.clamp(reduced, max=0.0)).sum(1)
    bound = torch.where(torch.isfinite(bound), bound, -inf)
    shift = (c64 * l64).sum(1)
    v = l + torch.where(active, col_s * x, 0.0)
    red_orig = reduced.to(dtype)
    return IPMResult(
        v=v,
        bound=bound + shift,
        obj=(c * v).sum(1),
        rp_norm=rp.abs().amax(1),
        rd_norm=rd.abs().amax(1),
        mu=mu,
        converged=done,
        reduced=reduced,
        y_dual=y,
        z_dual=torch.where(active, torch.clamp(red_orig, min=0.0), 0.0),
        f_dual=torch.where(active, torch.clamp(-red_orig, min=0.0), 0.0),
        iters_run=it,
        trace_buf=tbuf,
    )


def _pdhg_kernel(batch, iters, tol, restart_tol, warm, skip, chunk, trace) -> IPMResult:
    from ..kernels.build import library

    A, b, c, l, u = batch
    if not isinstance(A, ElemA):
        raise TypeError("the pdhg kernel reads A as values on its structure (ElemA)")
    dtype = A.values.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pdhg kernel takes float32 or float64 A, got {dtype}")
    B, n = c.shape
    m = b.shape[1]
    sp = A.sparsity
    if (sp.m, sp.n) != (m, n) or tuple(A.values.shape) != (B, sp.nnz):
        raise ValueError(f"A: structure ({sp.m}, {sp.n}) and values "
                         f"{tuple(A.values.shape)} do not match B={B}, (m, n) = {(m, n)}")
    dev = A.values.device
    if sp.index.device != dev:
        raise ValueError(f"the structure lies on {sp.index.device}, the values on {dev}")
    for name, t, shape in (("b", b, (B, m)), ("c", c, (B, n)),
                           ("l", l, (B, n)), ("u", u, (B, n))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    kw = dict(dtype=dtype, device=dev)
    chunk, n_chunks = chunking(iters, chunk)
    out = IPMResult(
        v=torch.empty((B, n), **kw),
        bound=torch.empty(B, dtype=torch.float64, device=dev),
        obj=torch.empty(B, **kw),
        rp_norm=torch.empty(B, **kw),
        rd_norm=torch.empty(B, **kw),
        mu=torch.empty(B, **kw),
        converged=torch.empty(B, dtype=torch.bool, device=dev),
        reduced=torch.empty((B, n), dtype=torch.float64, device=dev),
        y_dual=torch.empty((B, m), **kw),
        z_dual=torch.empty((B, n), **kw),
        f_dual=torch.empty((B, n), **kw),
        iters_run=torch.empty(B, dtype=torch.int32, device=dev),
        trace_buf=torch.zeros((B, n_chunks, TRACE_COLS), **kw) if trace else None,
    )
    if B == 0:
        return out
    b, c, l, u = (t.contiguous() for t in (b, c, l, u))
    shared = A.shared
    vals = A.values
    if vals.stride(1) != 1 or 0 < vals.stride(0) < sp.nnz:
        vals = vals.contiguous()
    vstride = vals.stride(0)
    if warm is not None:
        if tuple(warm.v.shape) != (B, n) or tuple(warm.y.shape) != (B, m) \
                or tuple(warm.z.shape) != (B, n) or tuple(warm.f.shape) != (B, n) \
                or tuple(warm.ok.shape) != (B,):
            raise ValueError("warm state shapes do not match the batch")
        # Finiteness is judged on the caller's values, before the cast.
        fin = (warm.ok.to(torch.bool) & torch.isfinite(warm.v).all(1)
               & torch.isfinite(warm.y).all(1) & torch.isfinite(warm.z).all(1)
               & torch.isfinite(warm.f).all(1))
        wv = warm.v.to(dtype).contiguous()
        wy = warm.y.to(dtype).contiguous()
        wok = fin.to(torch.uint8).contiguous()
    else:
        wv = wy = wok = None
    if skip is not None and tuple(skip.shape) != (B,):
        raise ValueError(f"skip: expected shape {(B,)}, got {tuple(skip.shape)}")
    sk = None if skip is None else skip.to(torch.uint8).contiguous()
    f64 = dtype == torch.float64
    route, C, plan = kernel_route(sp, dtype, _cluster_max(dev, f64))
    if route == "cluster":
        check_cluster_layout(plan, m, n, f64)
        ws, sizes, G = None, (), 0
    else:
        sizes = route_ws_sizes(route, B, m, n, f64)
        ws = torch.empty(sum(sizes), dtype=torch.uint8, device=dev)
        G = _grid_blocks(dev, f64)
    launches = k5_launch(
        route, C, None if plan is None else plan.buf, 0 if plan is None else plan.smem, ws,
        sizes, G, sp.index, sp.nnz, vals, vstride, b, c, l, u, wv, wy, wok, sk, out, chunk,
        n_chunks, tol, restart_tol, kernels.stream_handle(dev))
    name = k5_name(shared, trace)
    shape = k5_shape(B, m, n, shared, sp.nnz, route, C)
    for _ in range(launches):
        kernels.count_launch(name, shape)
    return out
