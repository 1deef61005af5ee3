"""Batched primal-dual interior-point solver for box-constrained LPs.

Problem form (every variable boxed)::

    min c'v   s.t.  A v = b,   l <= v <= u

shifted internally to ``x = v - l`` in ``[0, r]`` and column-equilibrated by
the box width. Each element of the batch runs Mehrotra's predictor-corrector
in the dtype of ``A`` (float32 on the main path); the Lagrangian bound::

    L(y) = b'y + sum_j r_j * min(0, (c - A'y)_j)    (+ c'l shift)

is evaluated in float64 from whatever dual the iteration reached, so it is a
valid lower bound for ANY y: truncation and float32 only cost tightness.

:func:`ipm_solve_batch` launches the hand-written CUDA kernel
(``kernels/csrc/ipm_kernel.cu``, one thread block per LP) on CUDA tensors and
runs :func:`ipm_solve_batch_reference`, the plain PyTorch version, on CPU
tensors. Both compute what ``distilp_tpu/ops/ipm.py::ipm_solve_batch``
computes element by element, including its chunked early exit: an element
stops at the first chunk boundary after it converged, and ``iters_run``
counts only the steps it executed. ``trace=True`` records the convergence
trace (:data:`TRACE_COLS`, B13) of both engines' kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..obs.compile_ledger import instrument as _instrument

IPM_DEFAULT_CHUNK = 4
THREADS = 256

# The convergence trace (``trace=True``): one row per executed chunk of each
# element, written at the chunk boundary,
#   [iters, rp_norm, rd_norm, gap, restarts, live]
# iters the element's cumulative executed steps, rp/rd the scaled system's
# residual inf-norms, gap the engine's gauge (the complementarity mu here;
# the normalized duality gap in ops/pdhg.py), restarts the cumulative count
# of chunks in which the PDHG's Halpern anchor restarted (0 for the IPM),
# live whether the element was iterating when the chunk started. An element
# writes rows only for the chunks it runs: the rows after it stopped, and
# every row of a skipped element, stay zero, as the reference's vmapped
# while_loop leaves them (``distilp_tpu/ops/ipm.py:60-71``). The untraced
# solve's results are bit-identical to the traced one's.
TRACE_COLS = 6


def n_trace_rows(iters: int, chunk: int) -> int:
    """Rows of the trace buffer of an (iters, chunk) budget."""
    return chunking(iters, chunk)[1]


# K1's routes, by where one LP's vectors and its packed factor live.
IPM_ROUTES = ("shared", "factor_global", "global")


def ipm_workspace(B: int, m: int, n: int, dtype, device):
    """(route, vector workspace bytes, factor workspace bytes) of K1 for B
    LPs of shape (m, n) on the CUDA ``device``, as the kernel library
    reckons them from its own layout and the shared memory a block can opt
    into: 'shared' keeps each LP's vectors and packed factor in shared
    memory (no workspace), 'factor_global' the vectors alone (a factor
    workspace of B slices), 'global' neither (both workspaces)."""
    from ..kernels.build import library

    route, vec, fac = ctypes.c_int(0), ctypes.c_size_t(0), ctypes.c_size_t(0)
    err = library("ipm").dtk_ipm_workspace(
        torch.device(device).index or 0, B, m, n, int(dtype == torch.float64),
        ctypes.byref(route), ctypes.byref(vec), ctypes.byref(fac),
    )
    kernels.check(err, "ipm workspace query")
    return IPM_ROUTES[route.value], int(vec.value), int(fac.value)


def ipm_workspace_route(m: int, n: int, dtype, device) -> str:
    """K1's route on ``device`` for LPs of shape (m, n), decided from the
    shapes alone (see :func:`ipm_workspace`)."""
    return ipm_workspace(1, m, n, dtype, device)[0]


class IPMSparsity(NamedTuple):
    """A's sparse structure as K1 reads it, built once per A by
    :func:`ipm_sparsity`. ``index`` is one int32 buffer: the rows of A
    (row pointers, columns, each nonzero's place in column order), the rows
    of A' (column pointers, rows), and the structural lower entries (i >= k,
    every diagonal) of A diag(theta) A' with each entry's contributing
    columns j in ascending order and the places of A[i, j] and A[k, j].
    ``src`` gives each nonzero's flat index into A (m*n), in column order:
    the kernel's values are ``A.reshape(..., m*n)[..., src]``."""

    m: int
    n: int
    nnz: int
    nent: int
    ncontrib: int
    index: torch.Tensor  # int32
    src: torch.Tensor  # (nnz,) int64

    def parts(self) -> dict:
        """The named pieces of ``index`` (views)."""
        m, n, nnz, nent, nc = self.m, self.n, self.nnz, self.nent, self.ncontrib
        sizes = dict(a_ptr=m + 1, a_col=nnz, a_pos=nnz, t_ptr=n + 1, t_row=nnz,
                     w_ptr=nent + 1, w_row=nent, w_col=nent, w_j=nc, w_pi=nc, w_pk=nc)
        return dict(zip(sizes, torch.split(self.index, list(sizes.values()))))


def ipm_sparsity(pattern: torch.Tensor) -> IPMSparsity:
    """K1's structure of an (m, n) nonzero pattern (bool; for a per-node A,
    the union over the nodes), built with tensor operations on the
    pattern's device."""
    m, n = pattern.shape
    dev = pattern.device
    i64 = dict(dtype=torch.int64, device=dev)
    jj, ii = pattern.t().nonzero(as_tuple=True)  # column order, rows ascending
    nnz = int(ii.numel())
    t_ptr = torch.zeros(n + 1, **i64)
    t_ptr[1:] = torch.cumsum(torch.bincount(jj, minlength=n), 0)
    a_pos = torch.argsort(ii * n + jj)  # row order -> place in column order
    a_ptr = torch.zeros(m + 1, **i64)
    a_ptr[1:] = torch.cumsum(torch.bincount(ii, minlength=m), 0)
    # Every pair of nonzeros (p, q) of one column with row(q) <= row(p)
    # contributes A[i, j] A[k, j] to W[i, k], i = row(p), k = row(q).
    rank = torch.arange(nnz, **i64) - t_ptr[jj]
    reps = rank + 1
    p = torch.repeat_interleave(torch.arange(nnz, **i64), reps)
    first = torch.cumsum(reps, 0) - reps
    q = t_ptr[jj[p]] + torch.arange(p.numel(), **i64) - torch.repeat_interleave(first, reps)
    diag = torch.arange(m, **i64)
    # Entries in column-major lower order (k, then i), contributions by j;
    # a marker (j = n) puts every diagonal in, contributions or not.
    stride = n + 1
    key = torch.cat([(ii[q] * m + ii[p]) * stride + jj[p], (diag * m + diag) * stride + n])
    order = torch.argsort(key)
    ent, inverse = torch.unique_consecutive(key[order] // stride, return_inverse=True)
    real = order < p.numel()
    sel = order[real]
    w_ptr = torch.zeros(ent.numel() + 1, **i64)
    w_ptr[1:] = torch.cumsum(torch.bincount(inverse[real], minlength=ent.numel()), 0)
    parts = [a_ptr, jj[a_pos], a_pos, t_ptr, ii, w_ptr, ent % m, ent // m,
             jj[p[sel]], p[sel], q[sel]]
    index = torch.cat(parts).to(torch.int32)
    return IPMSparsity(m=m, n=n, nnz=nnz, nent=int(ent.numel()), ncontrib=int(sel.numel()),
                       index=index, src=ii * n + jj)


def check_sparsity(A: torch.Tensor, sparsity: IPMSparsity) -> None:
    """Raise unless ``sparsity`` is the structure of an A of this shape on
    A's device whose pattern holds every nonzero of A (each element's, for
    a per-node A): K1 reads only the pattern's values, so a nonzero outside
    it would be dropped. One reduction and one read-back."""
    m, n = A.shape[-2:]
    if (sparsity.m, sparsity.n) != (m, n) or sparsity.index.device != A.device:
        raise ValueError(f"sparsity of a ({sparsity.m}, {sparsity.n}) A on "
                         f"{sparsity.index.device}, for A {tuple(A.shape)} on {A.device}")
    flat = A.reshape(*A.shape[:-2], m * n)
    if bool(((flat != 0).sum(-1) != (flat[..., sparsity.src] != 0).sum(-1)).any()):
        raise ValueError("A has a nonzero outside the sparsity pattern it was given")


class LPBatch(NamedTuple):
    """One LP family: A shared (m, n) or per element (B, m, n); b (B, m);
    c, l, u (B, n)."""

    A: torch.Tensor
    b: torch.Tensor
    c: torch.Tensor
    l: torch.Tensor
    u: torch.Tensor


class IPMWarmState(NamedTuple):
    """Warm-start iterate in ORIGINAL coordinates; ``ok`` (B,) bool gates each
    element (False or any non-finite component starts it cold)."""

    v: torch.Tensor  # (B, n)
    y: torch.Tensor  # (B, m)
    z: torch.Tensor  # (B, n)
    f: torch.Tensor  # (B, n)
    ok: torch.Tensor  # (B,) bool


class IPMResult(NamedTuple):
    v: torch.Tensor  # (B, n) primal point, original coordinates
    bound: torch.Tensor  # (B,) float64 rigorous lower bound
    obj: torch.Tensor  # (B,) c'v
    rp_norm: torch.Tensor  # (B,) primal residual inf-norm (scaled system)
    rd_norm: torch.Tensor  # (B,) dual residual inf-norm (scaled system)
    mu: torch.Tensor  # (B,) complementarity
    converged: torch.Tensor  # (B,) bool
    reduced: torch.Tensor  # (B, n) float64 reduced costs of the bound's dual
    y_dual: torch.Tensor  # (B, m)
    z_dual: torch.Tensor  # (B, n)
    f_dual: torch.Tensor  # (B, n)
    iters_run: torch.Tensor  # (B,) int32
    # (B, n_trace_rows, TRACE_COLS) in the iteration dtype with trace=True;
    # None untraced.
    trace_buf: Optional[torch.Tensor] = None


def _default_tol(dtype) -> float:
    return 1e-9 if dtype == torch.float64 else 1e-5


def _default_reg(dtype) -> float:
    return 1e-10 if dtype == torch.float64 else 1e-7


def chunking(iters: int, chunk: int):
    """(steps per chunk, number of chunks) of an (iters, chunk) budget: the
    loop runs up to ceil(iters/chunk)*chunk steps, as the reference does."""
    chunk = max(1, min(int(chunk), int(iters)))
    return chunk, -(-int(iters) // chunk)


def ipm_solve_batch(
    batch: LPBatch,
    iters: int = 30,
    tol: Optional[float] = None,
    reg: Optional[float] = None,
    warm: Optional[IPMWarmState] = None,
    skip: Optional[torch.Tensor] = None,
    chunk: int = IPM_DEFAULT_CHUNK,
    sparsity: Optional[IPMSparsity] = None,
    trace: bool = False,
    _checked: bool = False,
    _values: Optional[torch.Tensor] = None,
) -> IPMResult:
    """Solve a batch of boxed LPs: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``tol``/``reg`` default by dtype.
    ``sparsity`` is A's structure (:func:`ipm_sparsity`) when the caller
    keeps it across calls; every nonzero of A must lie in its pattern
    (:func:`check_sparsity`). The kernel's wrapper builds it from A
    otherwise. ``trace`` records the convergence trace (:data:`TRACE_COLS`)
    into ``trace_buf``. ``_checked`` and ``_values`` are the search's: a
    structure it checked against this A when it built it, and the kernel's
    values of a 2-D A on it."""
    if sparsity is not None and not _checked:
        check_sparsity(batch.A, sparsity)
    tensors = list(batch) + ([] if warm is None else list(warm)) + [skip]
    if kernels.on_cuda(*tensors):
        return _ipm_kernel(batch, iters, tol, reg, warm, skip, chunk, sparsity, trace, _values)
    return ipm_solve_batch_reference(batch, iters, tol, reg, warm, skip, chunk, trace)


ipm_solve_batch = _instrument("ops.ipm.ipm_solve_batch", ipm_solve_batch)


def _bmv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Per-element A @ x for A (B, m, n), x (B, n)."""
    return torch.bmm(A, x.unsqueeze(-1)).squeeze(-1)


def _bmvT(A: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-element A' @ y for A (B, m, n), y (B, m)."""
    return torch.bmm(A.transpose(1, 2), y.unsqueeze(-1)).squeeze(-1)


@contextlib.contextmanager
def _full_f32_matmul():
    """Full float32 products on a GPU (no TF32), as the reference pins
    "highest" precision: a TF32 normal matrix loses the dual."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def ipm_solve_batch_reference(
    batch: LPBatch,
    iters: int = 30,
    tol: Optional[float] = None,
    reg: Optional[float] = None,
    warm: Optional[IPMWarmState] = None,
    skip: Optional[torch.Tensor] = None,
    chunk: int = IPM_DEFAULT_CHUNK,
    trace: bool = False,
) -> IPMResult:
    """Plain PyTorch version of the IPM kernel (same signature and result)."""
    with _full_f32_matmul():
        return _reference(batch, iters, tol, reg, warm, skip, chunk, trace)


def _reference(batch, iters, tol, reg, warm, skip, chunk, trace) -> IPMResult:
    A, b, c, l, u = batch
    dtype = A.dtype
    dev = A.device
    tol = _default_tol(dtype) if tol is None else tol
    reg = _default_reg(dtype) if reg is None else reg
    B, n = c.shape
    m = b.shape[1]
    A3 = A.expand(B, m, n) if A.dim() == 2 else A
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)

    r_raw = u - l
    active = r_raw > 0
    b_hat = b - _bmv(A3, l)
    col_s = torch.where(active, r_raw, one)
    As = A3 * col_s[:, None, :]
    cm = torch.where(active, c * col_s, zero)
    act = active.to(dtype)
    n_active = torch.maximum(act.sum(1), one)

    x = torch.full((B, n), 0.5, dtype=dtype, device=dev)
    w = 1.0 - x
    z = torch.ones((B, n), dtype=dtype, device=dev)
    f = torch.ones((B, n), dtype=dtype, device=dev)
    y = torch.zeros((B, m), dtype=dtype, device=dev)
    if warm is not None:
        v_w, y_w, z_w, f_w = (t.to(dtype) for t in warm[:4])
        fin = (
            warm.ok.to(torch.bool)
            & torch.isfinite(v_w).all(1)
            & torch.isfinite(y_w).all(1)
            & torch.isfinite(z_w).all(1)
            & torch.isfinite(f_w).all(1)
        )[:, None]
        x_w = (torch.minimum(torch.maximum(v_w, l), u) - l) / col_s
        x_w = torch.clamp(x_w, 0.01, 0.99)
        x = torch.where(fin, x_w, x)
        w = torch.where(fin, 1.0 - x, w)
        z = torch.where(fin, torch.clamp(z_w * col_s, 1e-2, 1e4), z)
        f = torch.where(fin, torch.clamp(f_w * col_s, 1e-2, 1e4), f)
        y = torch.where(fin, y_w, y)

    b_scale = 1.0 + b_hat.abs().amax(1)
    c_scale = 1.0 + cm.abs().amax(1)
    eye = torch.eye(m, dtype=dtype, device=dev)
    tiny = 1e-300 if dtype == torch.float64 else 1e-30
    two_na = 2.0 * n_active
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    if skip is not None:
        done = done | skip.to(torch.bool)
    it = torch.zeros(B, dtype=torch.int32, device=dev)

    def max_step(v, dv):
        ratios = torch.where(
            active & (dv < 0), -v / torch.where(dv < 0, dv, -one), inf
        )
        return torch.minimum(one, 0.9995 * ratios.amin(1))

    def step(x, w, y, z, f, done, it):
        it = it + (~done).to(torch.int32)
        xa = x * act
        rp = b_hat - _bmv(As, xa)
        rd = (cm - _bmvT(As, y) - z + f) * act
        ru = (1.0 - x - w) * act
        mu = ((xa * z).sum(1) + ((w * act) * f).sum(1)) / two_na
        x_s = torch.where(active, x, one)
        w_s = torch.where(active, w, one)
        theta = act / (z / x_s + f / w_s)
        Mmat = torch.bmm(As * theta[:, None, :], As.transpose(1, 2)) + reg * eye
        L, info = torch.linalg.cholesky_ex(Mmat)
        # A failed factorization is all-NaN, as in the reference.
        L = torch.where((info != 0)[:, None, None], float("nan"), L)

        def directions(rc1, rc2):
            g = rd - rc1 / x_s + (rc2 - f * ru) / w_s
            rhs = rp + _bmv(As, theta * g)
            dy = torch.cholesky_solve(rhs.unsqueeze(-1), L).squeeze(-1)
            dx = theta * (_bmvT(As, dy) - g)
            dw = ru - dx
            dz = (rc1 - z * dx) / x_s
            df = (rc2 - f * dw) / w_s
            return dx, dw, dy, dz, df

        dxa, dwa, _, dza, dfa = directions(-x * z, -w * f)
        ap = torch.minimum(max_step(x, dxa), max_step(w, dwa))[:, None]
        ad = torch.minimum(max_step(z, dza), max_step(f, dfa))[:, None]
        mu_aff = (
            (((x + ap * dxa) * act) * (z + ad * dza)).sum(1)
            + (((w + ap * dwa) * act) * (f + ad * dfa)).sum(1)
        ) / two_na
        q = mu_aff / (mu + tiny)
        sigma = torch.clamp(q * q * q, 0.0, 1.0)[:, None]
        smu = sigma * mu[:, None]
        rc1 = smu - x * z - dxa * dza
        rc2 = smu - w * f - dwa * dfa
        dx, dw, dy, dz, df = directions(rc1, rc2)
        ap = torch.minimum(max_step(x, dx), max_step(w, dw))
        ad = torch.minimum(max_step(z, dz), max_step(f, df))
        fin = (
            torch.isfinite(dx).all(1)
            & torch.isfinite(dw).all(1)
            & torch.isfinite(dy).all(1)
            & torch.isfinite(dz).all(1)
            & torch.isfinite(df).all(1)
            & torch.isfinite(ap)
            & torch.isfinite(ad)
        )
        ap = torch.where(fin, ap, zero)[:, None]
        ad = torch.where(fin, ad, zero)[:, None]
        f2 = fin[:, None]
        dx, dw, dz, df = (torch.where(f2, t, zero) for t in (dx, dw, dz, df))
        dy = torch.where(f2, dy, zero)
        fr = done[:, None]
        x = torch.where(fr, x, x + ap * dx)
        w = torch.where(fr, w, w + ap * dw)
        y = torch.where(fr, y, y + ad * dy)
        z = torch.where(fr, z, z + ad * dz)
        f = torch.where(fr, f, f + ad * df)
        conv = (
            (mu < tol)
            & (rp.abs().amax(1) < tol * b_scale)
            & (rd.abs().amax(1) < tol * c_scale)
        )
        return x, w, y, z, f, done | conv, it

    def residuals(x, w, y, z, f):
        xa = x * act
        rp = b_hat - _bmv(As, xa)
        rd = cm - _bmvT(As, y) - z + f
        mu = ((xa * z).sum(1) + ((w * act) * f).sum(1)) / two_na
        return rp.abs().amax(1), (rd * act).abs().amax(1), mu

    chunk, n_chunks = chunking(iters, chunk)
    tbuf = torch.zeros((B, n_chunks, TRACE_COLS), dtype=dtype, device=dev) if trace else None
    for ci in range(n_chunks):
        if bool(done.all()):
            break
        live = ~done
        for _ in range(chunk):
            x, w, y, z, f, done, it = step(x, w, y, z, f, done, it)
        if trace:
            rp_n, rd_n, mu_n = residuals(x, w, y, z, f)
            row = torch.stack([it.to(dtype), rp_n, rd_n, mu_n, torch.zeros_like(mu_n),
                               torch.ones_like(mu_n)], 1)
            tbuf[:, ci] = torch.where(live[:, None], row, tbuf[:, ci])

    rp_norm, rd_norm, mu = residuals(x, w, y, z, f)

    f64 = torch.float64
    A64 = A3.to(f64)
    y64 = y.to(f64)
    r64 = (r_raw * act).to(f64)
    bh64 = b.to(f64) - _bmv(A64, l.to(f64))
    reduced = c.to(f64) - _bmvT(A64, y64)
    bound = (bh64 * y64).sum(1) + (r64 * torch.clamp(reduced, max=0.0)).sum(1)
    bound = torch.where(torch.isfinite(bound), bound, float("-inf"))
    shift = (c.to(f64) * l.to(f64)).sum(1)
    v = l + torch.where(active, col_s * x, zero)
    return IPMResult(
        v=v,
        bound=bound + shift,
        obj=(c * v).sum(1),
        rp_norm=rp_norm,
        rd_norm=rd_norm,
        mu=mu,
        converged=done,
        reduced=reduced,
        y_dual=y,
        z_dual=torch.where(active, z / col_s, zero),
        f_dual=torch.where(active, f / col_s, zero),
        iters_run=it,
        trace_buf=tbuf,
    )


def _ipm_kernel(batch, iters, tol, reg, warm, skip, chunk, sparsity, trace,
                values=None) -> IPMResult:
    from ..kernels.build import library

    A, b, c, l, u = batch
    dtype = A.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ipm kernel takes float32 or float64 A, got {dtype}")
    B, n = c.shape
    m = b.shape[1]
    if A.dim() == 2:
        if A.shape != (m, n):
            raise ValueError(f"A {tuple(A.shape)} does not match (m, n) = {(m, n)}")
        a_stride = 0
    elif A.dim() == 3 and A.shape == (B, m, n):
        a_stride = m * n
    else:
        raise ValueError(f"A {tuple(A.shape)} is neither (m, n) nor (B, m, n)")
    A = A.contiguous()
    if sparsity is None:
        sparsity = ipm_sparsity(A != 0 if A.dim() == 2 else (A != 0).any(0))
    if values is None or A.dim() != 2:
        values = A.reshape(*A.shape[:-2], m * n)[..., sparsity.src]
    vals = values.contiguous()
    for name, t, shape in (("b", b, (B, m)), ("c", c, (B, n)),
                           ("l", l, (B, n)), ("u", u, (B, n))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    b, c, l, u = (t.contiguous() for t in (b, c, l, u))
    dev = A.device
    kw = dict(dtype=dtype, device=dev)
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
    )
    chunk, n_chunks = chunking(iters, chunk)
    if trace:
        out = out._replace(trace_buf=torch.zeros((B, n_chunks, TRACE_COLS), **kw))
    if B == 0:
        return out
    if warm is not None:
        wv, wy, wz, wf = (t.to(dtype).contiguous() for t in warm[:4])
        if wv.shape != (B, n) or wy.shape != (B, m) or wz.shape != (B, n) \
                or wf.shape != (B, n) or warm.ok.shape != (B,):
            raise ValueError("warm state shapes do not match the batch")
        wok = warm.ok.to(torch.uint8).contiguous()
    else:
        wv = wy = wz = wf = wok = None
    sk = None if skip is None else skip.to(torch.uint8).contiguous()
    _, vec_bytes, factor_bytes = ipm_workspace(B, m, n, dtype, dev)
    ws = torch.empty(factor_bytes // A.element_size(), **kw) if factor_bytes else None
    vec_ws = torch.empty(vec_bytes // A.element_size(), **kw) if vec_bytes else None
    lib = library("ipm")
    fn = lib.dtk_ipm_f64 if dtype == torch.float64 else lib.dtk_ipm_f32
    P, O = kernels.ptr, kernels.opt_ptr
    err = fn(
        P(A), a_stride, P(sparsity.index), sparsity.nnz, sparsity.nent, sparsity.ncontrib,
        P(vals), sparsity.nnz if A.dim() == 3 else 0, P(b), P(c), P(l), P(u),
        O(wv), O(wy), O(wz), O(wf), O(wok), O(sk),
        B, m, n, chunk, n_chunks,
        float(_default_tol(dtype) if tol is None else tol),
        float(_default_reg(dtype) if reg is None else reg),
        O(ws), O(vec_ws), P(out.v), P(out.bound), P(out.obj), P(out.rp_norm),
        P(out.rd_norm), P(out.mu), P(out.converged), P(out.reduced),
        P(out.y_dual), P(out.z_dual), P(out.f_dual), P(out.iters_run),
        O(out.trace_buf), n_chunks, THREADS, kernels.stream_handle(dev),
    )
    kernels.check(err, "ipm")
    kernels.count_launch("ipm_trace" if trace else "ipm",
                         f"B={B} m={m} n={n}{' per-node A' if a_stride else ''}")
    return out
