"""Batched restarted Halpern PDHG for box-constrained LPs: the matrix-free
fleet-scale sibling of :mod:`distilp_torch.ops.ipm`.

Same problem family, batch layout (:class:`~distilp_torch.ops.ipm.LPBatch`
with one shared (m, n) A) and result contract
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

:func:`pdhg_solve_batch` launches the hand-written CUDA kernel
(``kernels/csrc/pdhg_kernel.cu``, one cooperative launch per batch of up to
:data:`BMAX` elements) on CUDA tensors and runs
:func:`pdhg_solve_batch_reference`, the plain PyTorch version, on CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels
from .ipm import IPMResult, LPBatch, _full_f32_matmul, chunking

# Convergence-test granularity (steps per chunk).
PDHG_DEFAULT_CHUNK = 32
# Sufficient-decay factor of the adaptive restart.
DEFAULT_RESTART_TOL = 0.2
# Iterate-precision knob values ('f32' iterates with the f64 certificate;
# 'f64' is the soundness rung an uncertified f32 run escalates to).
PDHG_DTYPES = ("f32", "f64")
# Elements per kernel launch; a larger batch is solved in slices (elements
# are independent: a finished element is frozen whatever the others do).
BMAX = 16


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
) -> IPMResult:
    """Solve a batch of boxed LPs sharing one (m, n) A: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors.

    ``iters`` is the per-element budget, spent ``chunk`` steps at a time with
    a batch-wide convergence test between chunks; ``restart_tol`` is the
    restart's sufficient-decay factor; ``warm`` takes a
    :class:`PDHGWarmState` or an ``IPMWarmState``. ``dtype`` ('f32'/'f64',
    None = the batch's own) sets the iteration precision: the batch is cast
    on entry, the certificate stays the float64 bound either way.
    """
    if trace:
        raise NotImplementedError(
            "PDHG convergence traces are not ported yet (ROADMAP.md A9)"
        )
    dt = resolve_pdhg_dtype(dtype)
    if dt is not None and dt != batch.A.dtype:
        batch = LPBatch(*(t.to(dt) for t in batch))
    if batch.A.dim() != 2:
        raise ValueError(
            f"pdhg_solve_batch takes one shared (m, n) A, got {tuple(batch.A.shape)}"
        )
    tol_v = _default_tol_pdhg(batch.A.dtype) if tol is None else float(tol)
    rt_v = DEFAULT_RESTART_TOL if restart_tol is None else float(restart_tol)
    tensors = list(batch) + ([] if warm is None else list(warm)) + [skip]
    if kernels.on_cuda(*tensors):
        return _pdhg_kernel(batch, iters, tol_v, rt_v, warm, skip, chunk)
    return pdhg_solve_batch_reference(batch, iters, tol_v, rt_v, warm, skip, chunk)


def pdhg_solve_batch_reference(
    batch: LPBatch,
    iters: int = 1000,
    tol: Optional[float] = None,
    restart_tol: Optional[float] = None,
    warm=None,
    skip: Optional[torch.Tensor] = None,
    chunk: int = PDHG_DEFAULT_CHUNK,
) -> IPMResult:
    """Plain PyTorch version of the PDHG kernel (batch axis written out)."""
    tol = _default_tol_pdhg(batch.A.dtype) if tol is None else tol
    restart_tol = DEFAULT_RESTART_TOL if restart_tol is None else restart_tol
    with _full_f32_matmul():
        return _reference(batch, iters, tol, restart_tol, warm, skip, chunk)


def _reference(batch, iters, tol, restart_tol, warm, skip, chunk) -> IPMResult:
    A, b, c, l, u = batch
    dtype, dev = A.dtype, A.device
    B, n = c.shape
    m = A.shape[0]
    inf = float("inf")

    r_raw = u - l
    active = r_raw > 0
    b_hat = b - l @ A.T
    col_s = torch.where(active, r_raw, 1.0)
    cs_a = torch.where(active, r_raw, 0.0)
    act = active.to(dtype)
    cm = torch.where(active, c * col_s, 0.0)
    absA = A.abs()
    # Row inf-norms of |A| diag(cs_a), one element at a time: never a
    # (B, m, n) scaled copy of A.
    row_max = torch.stack([(absA * cs_a[e]).amax(1) for e in range(B)]) if B else \
        torch.zeros((0, m), dtype=dtype, device=dev)
    row_s = 1.0 / torch.clamp(row_max, min=1e-12)
    b_s = b_hat * row_s

    def opA(x):
        return row_s * ((cs_a * x) @ A.T)

    def opAT(y):
        return cs_a * ((row_s * y) @ A)

    row_1n = row_s * (cs_a @ absA.T)
    col_1n = cs_a * (row_s @ absA)
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

    def conv_of(x, y):
        rp = b_s - opA(x)
        obj = (cm * x).sum(1)
        red = cm - opAT(y)
        lag = (b_s * y).sum(1) + (act * torch.clamp(red, max=0.0)).sum(1)
        gap = (obj - lag).abs()
        return (rp.abs().amax(1) < tol * b_scale) & (
            gap < tol * (b_scale + c_scale + obj.abs())
        )

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
    for _ in range(n_chunks):
        if bool(done.all()):
            break
        live = ~done
        for _ in range(chunk):
            x, y, xa, ya, res_a, t, it = step(x, y, xa, ya, res_a, t, it, live)
        done = done | (live & conv_of(x, y))

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
    bh64 = b.to(f64) - l64 @ A64.T
    reduced = c64 - y64 @ A64
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
    )


def _pdhg_kernel(batch, iters, tol, restart_tol, warm, skip, chunk) -> IPMResult:
    from ..kernels.build import library

    A, b, c, l, u = batch
    dtype = A.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pdhg kernel takes float32 or float64 A, got {dtype}")
    B, n = c.shape
    m = b.shape[1]
    if tuple(A.shape) != (m, n):
        raise ValueError(f"A {tuple(A.shape)} does not match (m, n) = {(m, n)}")
    for name, t, shape in (("b", b, (B, m)), ("c", c, (B, n)),
                           ("l", l, (B, n)), ("u", u, (B, n))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
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
    if B == 0:
        return out
    A = A.contiguous()
    At = A.t().contiguous()  # column products read rows of A'
    b, c, l, u = (t.contiguous() for t in (b, c, l, u))
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
    chunk, n_chunks = chunking(iters, chunk)
    lib = library("pdhg")
    f64 = dtype == torch.float64
    fn = lib.dtk_pdhg_f64 if f64 else lib.dtk_pdhg_f32
    P, O = kernels.ptr, kernels.opt_ptr
    for s in range(0, B, BMAX):
        e = min(B, s + BMAX)
        nb = e - s
        ws = torch.empty(int(lib.dtk_pdhg_ws_bytes(nb, m, n, int(f64))),
                         dtype=torch.uint8, device=dev)
        sl = lambda t: None if t is None else t[s:e]  # noqa: E731
        err = fn(
            P(A), P(At), P(b[s:e]), P(c[s:e]), P(l[s:e]), P(u[s:e]),
            O(sl(wv)), O(sl(wy)), O(sl(wok)), O(sl(sk)),
            nb, m, n, chunk, n_chunks, float(tol), float(restart_tol),
            P(ws), ws.numel(),
            P(out.v[s:e]), P(out.bound[s:e]), P(out.obj[s:e]),
            P(out.rp_norm[s:e]), P(out.rd_norm[s:e]), P(out.mu[s:e]),
            P(out.converged[s:e]), P(out.reduced[s:e]), P(out.y_dual[s:e]),
            P(out.z_dual[s:e]), P(out.f_dual[s:e]), P(out.iters_run[s:e]),
            kernels.stream_handle(dev),
        )
        kernels.check(err, "pdhg")
        kernels.LAUNCHES["pdhg"] += 1
    return out
