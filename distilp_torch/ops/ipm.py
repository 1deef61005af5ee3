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
counts only the steps it executed.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple, Optional

import torch

from .. import kernels

IPM_DEFAULT_CHUNK = 4
THREADS = 256


def ipm_vec_workspace_bytes(B: int, m: int, n: int, dtype, device) -> int:
    """Bytes of K1's global vector workspace for B LPs of shape (m, n) on the
    CUDA ``device``, as the kernel library reckons it from its own vector
    layout and shared-memory figures: 0 when each LP's vectors fit the
    shared memory a block can opt into (the shared route), else B per-block
    slices (the global route)."""
    from ..kernels.build import library

    out = ctypes.c_size_t(0)
    err = library("ipm").dtk_ipm_vec_ws_bytes(
        torch.device(device).index or 0, B, m, n, int(dtype == torch.float64),
        ctypes.byref(out),
    )
    kernels.check(err, "ipm workspace query")
    return int(out.value)


def ipm_workspace_route(m: int, n: int, dtype, device) -> str:
    """Where K1 keeps each LP's vectors on ``device``: 'shared' (block shared
    memory) or 'global' (a per-block slice of a workspace the wrapper
    allocates). Decided from the shapes alone."""
    return "global" if ipm_vec_workspace_bytes(1, m, n, dtype, device) else "shared"


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
) -> IPMResult:
    """Solve a batch of boxed LPs: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``tol``/``reg`` default by dtype."""
    tensors = list(batch) + ([] if warm is None else list(warm)) + [skip]
    if kernels.on_cuda(*tensors):
        return _ipm_kernel(batch, iters, tol, reg, warm, skip, chunk)
    return ipm_solve_batch_reference(batch, iters, tol, reg, warm, skip, chunk)


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
) -> IPMResult:
    """Plain PyTorch version of the IPM kernel (same signature and result)."""
    with _full_f32_matmul():
        return _reference(batch, iters, tol, reg, warm, skip, chunk)


def _reference(batch, iters, tol, reg, warm, skip, chunk) -> IPMResult:
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

    chunk, n_chunks = chunking(iters, chunk)
    for _ in range(n_chunks):
        if bool(done.all()):
            break
        for _ in range(chunk):
            x, w, y, z, f, done, it = step(x, w, y, z, f, done, it)

    xa = x * act
    rp = b_hat - _bmv(As, xa)
    rd = cm - _bmvT(As, y) - z + f
    mu = ((xa * z).sum(1) + ((w * act) * f).sum(1)) / two_na

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
        rp_norm=rp.abs().amax(1),
        rd_norm=(rd * act).abs().amax(1),
        mu=mu,
        converged=done,
        reduced=reduced,
        y_dual=y,
        z_dual=torch.where(active, z / col_s, zero),
        f_dual=torch.where(active, f / col_s, zero),
        iters_run=it,
    )


def _ipm_kernel(batch, iters, tol, reg, warm, skip, chunk) -> IPMResult:
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
        At = A.t().contiguous()
    elif A.dim() == 3 and A.shape == (B, m, n):
        a_stride = m * n
        At = A.transpose(1, 2).contiguous()
    else:
        raise ValueError(f"A {tuple(A.shape)} is neither (m, n) nor (B, m, n)")
    A = A.contiguous()
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
    ws = torch.empty(B * m * m, **kw)
    vec_bytes = ipm_vec_workspace_bytes(B, m, n, dtype, dev)
    vec_ws = torch.empty(vec_bytes // A.element_size(), **kw) if vec_bytes else None
    chunk, n_chunks = chunking(iters, chunk)
    lib = library("ipm")
    fn = lib.dtk_ipm_f64 if dtype == torch.float64 else lib.dtk_ipm_f32
    P, O = kernels.ptr, kernels.opt_ptr
    err = fn(
        P(A), P(At), a_stride, P(b), P(c), P(l), P(u),
        O(wv), O(wy), O(wz), O(wf), O(wok), O(sk),
        B, m, n, chunk, n_chunks,
        float(_default_tol(dtype) if tol is None else tol),
        float(_default_reg(dtype) if reg is None else reg),
        P(ws), O(vec_ws), P(out.v), P(out.bound), P(out.obj), P(out.rp_norm),
        P(out.rd_norm), P(out.mu), P(out.converged), P(out.reduced),
        P(out.y_dual), P(out.z_dual), P(out.f_dual), P(out.iters_run),
        THREADS, kernels.stream_handle(dev),
    )
    kernels.check(err, "ipm")
    kernels.LAUNCHES["ipm"] += 1
    return out
