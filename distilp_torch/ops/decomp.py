"""Lagrangian decomposition root bounds of the MoE MILP (kernel K7).

Dualize the two coupling rows (sum w = W, sum y = E) and split the cycle
weight (k - 1) over the devices as theta_i = (k - 1) softmax(tau)_i. For any
multipliers (lambda, mu, tau) the per-device subproblems decouple and are
solved exactly over each device's integer lattice (five n candidates, w in
[1, w_max], y in [0, e_max]), so

    bound(lambda, mu, tau) = sum_i min_{cells} [lin_i + theta_i cyc_i
                             - lambda w - mu y] + lambda W + mu E

is a rigorous lower bound on the fixed-k MILP (it sees the per-device
integrality the LP relaxation cannot). The multipliers are improved by an
Adam ascent on the float32 bound; the returned bound is one float64
evaluation at the best multipliers, so float32 only costs tightness.

Ported from ``distilp_tpu/solver/backend_jax.py`` (``_decomp_terms``,
``_decomp_terms_for_w``, ``_decomp_bound_roots``). Two evaluations, one
kernel source (``kernels/csrc/decomp_kernel.cu``):

- :func:`eval32` the float32 bound and, for the gradient, the tie-averaged
  w, y and cyc of each (k, device)'s minimizing cells (``jnp.min``'s
  gradient splits the cotangent equally over ties); :class:`DecompBound32`
  is the ``torch.autograd.Function`` around it;
- :func:`eval64` the float64 per-(k, device, y) minima ``m_y``, the
  feasibility flags and, on cold solves, the Lagrangian-primal hint cell.

On CUDA tensors they launch the kernel, on CPU tensors they run the plain
PyTorch versions (the straightforward broadcast of ``_decomp_terms_for_w``).
:func:`decomp_bound_roots` is the ascent: a host loop of tensor operations
with no device-to-host read, one evaluation per step (the evaluation at the
new multipliers gives both the bound for the best-of tracking and the next
step's gradient).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels

# Per-device vectors the kernel reads, packed as rows of a (15, M) matrix in
# the evaluation's dtype (the reference casts each before any arithmetic).
RD_DEV_FIELDS = (
    "a", "b_gpu", "pen_set", "pen_vram", "busy_const", "s_disk", "ram_rhs",
    "ram_minus_n", "cuda_rhs", "metal_rhs", "has_gpu", "eb_ram", "eb_vram",
    "eb_metal", "g_raw",
)
BIG32 = 3.4e37  # the float32 evaluation's value of an infeasible cell
N_CANDS = 5
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-12


class DecompProblem(NamedTuple):
    """One sweep's decomposition data in one dtype, on one device."""

    rdv: torch.Tensor  # (15, M) RD_DEV_FIELDS rows
    bp: float  # b' in this dtype (a host value: no read from the device)
    E: float  # routed experts
    ks: torch.Tensor  # (n_k,)
    Ws: torch.Tensor  # (n_k,)
    w_max: int
    e_max: int

    @property
    def dtype(self):
        return self.rdv.dtype

    def field(self, name: str) -> torch.Tensor:
        return self.rdv[RD_DEV_FIELDS.index(name)]


def decomp_problem(rd_np: dict, ks, Ws, w_max: int, e_max: int, dtype,
                   device) -> DecompProblem:
    """The problem from the host (numpy, float64) rounding data, every
    vector cast to ``dtype`` first."""
    npdt = np.float32 if dtype == torch.float32 else np.float64
    rdv = np.stack([np.asarray(rd_np[f], np.float64) for f in RD_DEV_FIELDS]).astype(npdt)
    T = lambda a: torch.as_tensor(np.asarray(a, np.float64).astype(npdt), device=device)  # noqa: E731
    return DecompProblem(
        rdv=torch.as_tensor(rdv, device=device).contiguous(),
        bp=float(npdt(rd_np["bprime"])),
        E=float(npdt(rd_np["E"])),
        ks=T(ks),
        Ws=T(Ws),
        w_max=int(w_max),
        e_max=int(e_max),
    )


# ------------------------------------------------------------ plain version


def decomp_cells(p: DecompProblem):
    """(lin, cyc, ok) of every cell, each (5, n_k, M, w_max, e_max+1), in
    ``p.dtype``: ``_decomp_terms_for_w``'s broadcast, operation for
    operation (MoE rows: t <= n)."""
    dt, dev = p.dtype, p.rdv.device
    w_vals = torch.arange(1, p.w_max + 1, dtype=dt, device=dev)
    y_vals = torch.arange(0, p.e_max + 1, dtype=dt, device=dev)
    Wg = w_vals[None, None, :, None]
    Yg = y_vals[None, None, None, :]
    Wj = p.Ws[:, None, None, None]
    kj = p.ks[:, None, None, None]

    def dev_(name):
        return p.field(name)[None, :, None, None]

    a, b_gpu = dev_("a"), dev_("b_gpu")
    pen_set, pen_vram = dev_("pen_set"), dev_("pen_vram")
    busy_const, s_disk = dev_("busy_const"), dev_("s_disk")
    ram_rhs, rm = dev_("ram_rhs"), dev_("ram_minus_n")
    cuda, metal, hg = dev_("cuda_rhs"), dev_("metal_rhs"), dev_("has_gpu")
    ebr, ebv, ebm = dev_("eb_ram"), dev_("eb_vram"), dev_("eb_metal")
    g_k = dev_("g_raw") / kj
    bp = torch.tensor(p.bp, dtype=dt, device=dev)
    E = torch.tensor(p.E, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    vram_rhs = torch.minimum(cuda - ebv * Yg, metal - ebm * Yg)
    n_boundary = clip(torch.floor(vram_rhs / bp), zero, Wg) * hg
    n_boundary = torch.where(torch.isfinite(n_boundary), n_boundary, Wg * hg)
    ram_kink = clip(torch.ceil((bp * Wg + ebr * Yg - ram_rhs) / bp - 1e-9), zero, Wg) * hg * rm
    ram_kink = torch.where(torch.isfinite(ram_kink), ram_kink, zero)
    n_smin = clip(torch.ceil((ebr * Yg - ram_rhs) / bp - 1e-9), zero, Wg) * hg * rm
    n_smin = torch.where(torch.isfinite(n_smin), n_smin, zero)
    shape = torch.broadcast_shapes(n_boundary.shape, ram_kink.shape, (1, 1, 1) + tuple(Yg.shape[-1:]))
    n_cands = torch.stack([
        torch.zeros(shape, dtype=dt, device=dev),
        (Wg * hg).expand(shape),
        n_boundary.expand(shape),
        ram_kink.expand(shape),
        n_smin.expand(shape),
    ])
    resident = bp * Wg - bp * n_cands * rm + ebr * Yg
    s_ram = torch.ceil(torch.clamp(resident - ram_rhs, min=0.0) / bp - 1e-9)
    ok = s_ram <= torch.minimum(Wg, Wj)
    viol_v = torch.clamp(
        torch.maximum(bp * n_cands + ebv * Yg - cuda, bp * n_cands + ebm * Yg - metal),
        min=0.0,
    )
    viol_v = torch.where(torch.isfinite(viol_v), viol_v, zero)
    t = torch.ceil(viol_v / bp - 1e-9)
    ok = ok & (t <= n_cands + 1e-9)
    ok = ok & (Wg <= Wj) & (Yg <= E)
    lin = a * Wg + b_gpu * n_cands + pen_set * s_ram + pen_vram * t + g_k * Yg
    cyc = lin + busy_const + 0.5 * (bp / s_disk) * Wg
    return lin, cyc, ok.expand(lin.shape)


def _grid(p: DecompProblem):
    dt, dev = p.dtype, p.rdv.device
    wv = torch.arange(1, p.w_max + 1, dtype=dt, device=dev)[None, None, None, :, None]
    yv = torch.arange(0, p.e_max + 1, dtype=dt, device=dev)[None, None, None, None, :]
    return wv, yv


def _terms(p, cells, lam, mu, theta):
    lin, cyc, ok = cells
    wv, yv = _grid(p)
    term = (
        lin
        + theta[None, :, :, None, None] * cyc
        - lam[None, :, None, None, None] * wv
        - mu[None, :, None, None, None] * yv
    )
    return term, ok, wv, yv


def eval32_reference(p: DecompProblem, lam, mu, theta, cells=None):
    """Plain version of the float32 evaluation: (min, w_bar, y_bar, cyc_bar),
    each (n_k, M); a (k, device) with no feasible cell has min 3.4e37 and
    zero means. ``cells`` = :func:`decomp_cells` of ``p``, when the caller
    keeps them."""
    cells = decomp_cells(p) if cells is None else cells
    term, ok, wv, yv = _terms(p, cells, lam, mu, theta)
    term = torch.where(ok, term, torch.tensor(BIG32, dtype=term.dtype, device=term.device))
    mn = term.amin(dim=(0, 3, 4))
    tie = ok & (term == mn[None, :, :, None, None])
    cnt = tie.sum(dim=(0, 3, 4)).to(torch.float64)
    f64 = torch.float64

    def mean(x):
        s = torch.where(tie, x.to(f64), 0.0).sum(dim=(0, 3, 4))
        return torch.where(cnt > 0, s / cnt.clamp(min=1.0), 0.0).to(term.dtype)

    return mn, mean(wv.expand_as(term)), mean(yv.expand_as(term)), mean(cells[1])


def eval64_reference(p: DecompProblem, lam, mu, theta, track_hint: bool):
    """Plain version of the float64 evaluation: (m_y (n_k, M, e_max+1),
    any_ok (n_k, M), hint_w (n_k, M), hint_flat (n_k, M)); the hint is the
    smallest w attaining the minimum and within it the first (candidate, y)
    in candidate-major order (w 1, index 0 when no cell is feasible)."""
    cells = decomp_cells(p)
    term, ok, _, _ = _terms(p, cells, lam, mu, theta)
    term = torch.where(ok, term, float("inf"))  # (5, n_k, M, W, Y)
    m_y = term.amin(dim=(0, 3))
    any_ok = ok.any(dim=(0, 3, 4))
    n_k, M = m_y.shape[:2]
    Y = p.e_max + 1
    if not track_hint:
        z = torch.zeros((n_k, M), dtype=term.dtype, device=term.device)
        return m_y, any_ok, z, z.to(torch.int32)
    # (n_k, M, W, 5, Y) -> per w the flat (candidate, y) slice.
    t2 = term.permute(1, 2, 3, 0, 4).reshape(n_k, M, p.w_max, N_CANDS * Y)
    slice_min, slice_arg = t2.min(dim=3)
    best = slice_min.amin(dim=2, keepdim=True)
    finite = torch.isfinite(best)
    first_w = (slice_min == best).to(torch.int64).argmax(dim=2)
    hint_w = torch.where(finite[..., 0], first_w + 1, 1).to(term.dtype)
    flat = slice_arg.gather(2, first_w[..., None])[..., 0]
    hint_flat = torch.where(finite[..., 0], flat, 0).to(torch.int32)
    return m_y, any_ok, hint_w, hint_flat


# ------------------------------------------------------------ kernel route


def _check_inputs(p: DecompProblem, lam, mu, theta, dtype):
    """(n_k, M) of a kernel call; raises on what the kernel does not take."""
    n_k, M = theta.shape
    if p.dtype != dtype or any(t.dtype != dtype for t in (lam, mu, theta)):
        raise TypeError(f"this decomposition evaluation takes {dtype} tensors")
    if p.rdv.shape != (len(RD_DEV_FIELDS), M) or lam.shape != (n_k,) or mu.shape != (n_k,):
        raise ValueError("decomposition inputs do not match (n_k, M)")
    return n_k, M


def eval32_kernel(p: DecompProblem, lam, mu, theta):
    """K7's float32 entry on CUDA tensors: what :func:`eval32_reference`
    returns, at ``theta`` = (k - 1) softmax(tau)."""
    from ..kernels.build import library

    n_k, M = _check_inputs(p, lam, mu, theta, torch.float32)
    dev = p.rdv.device
    outs = [torch.empty((n_k, M), dtype=torch.float32, device=dev) for _ in range(4)]
    P = kernels.ptr
    c = lambda t: t.contiguous()  # noqa: E731
    err = library("decomp").dtk_decomp_eval_f32(
        P(c(p.rdv)), p.bp, p.E, P(c(p.ks)), P(c(p.Ws)), n_k, M, p.w_max, p.e_max,
        P(c(lam)), P(c(mu)), P(c(theta)), *[P(o) for o in outs],
        kernels.stream_handle(dev),
    )
    kernels.check(err, "decomp")
    kernels.LAUNCHES["decomp"] += 1
    return tuple(outs)


def eval64_kernel(p: DecompProblem, lam, mu, theta, track_hint: bool):
    """K7's float64 entry on CUDA tensors: what :func:`eval64_reference`
    returns."""
    from ..kernels.build import library

    n_k, M = _check_inputs(p, lam, mu, theta, torch.float64)
    dev = p.rdv.device
    Y = p.e_max + 1
    m_y = torch.empty((n_k, M, Y), dtype=torch.float64, device=dev)
    any_ok = torch.empty((n_k, M), dtype=torch.uint8, device=dev)
    hint_w = torch.zeros((n_k, M), dtype=torch.float64, device=dev)
    hint_flat = torch.zeros((n_k, M), dtype=torch.int32, device=dev)
    P = kernels.ptr
    c = lambda t: t.contiguous()  # noqa: E731
    err = library("decomp").dtk_decomp_eval_f64(
        P(c(p.rdv)), p.bp, p.E, P(c(p.ks)), P(c(p.Ws)), n_k, M, p.w_max, p.e_max,
        P(c(lam)), P(c(mu)), P(c(theta)), int(track_hint), P(m_y), P(any_ok),
        P(hint_w), P(hint_flat), kernels.stream_handle(dev),
    )
    kernels.check(err, "decomp")
    kernels.LAUNCHES["decomp"] += 1
    return m_y, any_ok.to(torch.bool), hint_w, hint_flat


# ------------------------------------------------------------ evaluations


def softmax(tau: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(tau, axis=1)`` as it computes it."""
    e = torch.exp(tau - tau.amax(dim=1, keepdim=True))
    return e / e.sum(dim=1, keepdim=True)


def eval32(p: DecompProblem, lam, mu, tau, cells=None):
    """(b (n_k,), stats) of the float32 bound at (lam, mu, tau); ``stats``
    = (w_bar, y_bar, cyc_bar, softmax(tau)) feeds :func:`bound_grads`."""
    s = softmax(tau)
    theta = (p.ks - 1.0)[:, None] * s
    if kernels.on_cuda(p.rdv, lam, mu, tau):
        mn, wbar, ybar, cycbar = eval32_kernel(p, lam, mu, theta)
    else:
        mn, wbar, ybar, cycbar = eval32_reference(p, lam, mu, theta, cells)
    b = mn.sum(dim=1) + lam * p.Ws + mu * p.E
    return b, (wbar, ybar, cycbar, s)


def bound_grads(p: DecompProblem, stats, grad_b):
    """Gradients of sum(grad_b * b) with respect to (lam, mu, tau)."""
    wbar, ybar, cycbar, s = stats
    g_lam = grad_b * (p.Ws - wbar.sum(dim=1))
    g_mu = grad_b * (p.E - ybar.sum(dim=1))
    ct_s = (p.ks - 1.0)[:, None] * (grad_b[:, None] * cycbar)
    g_tau = s * ct_s - s * (s * ct_s).sum(dim=1, keepdim=True)
    return g_lam, g_mu, g_tau


class DecompBound32(torch.autograd.Function):
    """b = bound(lam, mu, tau) in float32 (:func:`eval32`), differentiable:
    the backward pass spreads each (k, device)'s cotangent equally over its
    tied minimizing cells."""

    @staticmethod
    def forward(ctx, lam, mu, tau, problem: DecompProblem):
        b, stats = eval32(problem, lam, mu, tau)
        ctx.problem = problem
        ctx.stats = stats
        return b

    @staticmethod
    def backward(ctx, grad_b):
        g_lam, g_mu, g_tau = bound_grads(ctx.problem, ctx.stats, grad_b)
        return g_lam, g_mu, g_tau, None


def eval64(p: DecompProblem, lam, mu, tau, track_hint: bool):
    """The float64 evaluation at (lam, mu, tau): (bound (n_k,), m_y,
    any_ok, hint_w, hint_flat). The bound is -inf where it is NaN and +inf
    for a k in which some device has no feasible cell."""
    theta = (p.ks - 1.0)[:, None] * softmax(tau)
    if kernels.on_cuda(p.rdv, lam, mu, tau):
        m_y, any_ok, hint_w, hint_flat = eval64_kernel(p, lam, mu, theta, track_hint)
    else:
        m_y, any_ok, hint_w, hint_flat = eval64_reference(p, lam, mu, theta, track_hint)
    return bound_of(p, m_y, any_ok, lam, mu), m_y, any_ok, hint_w, hint_flat


def bound_of(p: DecompProblem, m_y, any_ok, lam, mu) -> torch.Tensor:
    """The per-k bound from the y-profile: sum over devices of the minimum
    over y, plus lam W + mu E; -inf where NaN, +inf for a k in which some
    device has no feasible cell."""
    bound = m_y.amin(dim=2).sum(dim=1) + lam * p.Ws + mu * p.E
    bound = torch.where(torch.isnan(bound), float("-inf"), bound)
    return torch.where(any_ok.all(dim=1), bound, float("inf"))


def _adam_constants(steps: int):
    """Per-step (lr, 1 - b1^t, 1 - b2^t), float32 as the reference computes
    them: three learning-rate phases of 0.01, 0.1 and 1."""
    f = np.float32
    phase_len = max(1, steps // 3)
    out = []
    for i in range(steps):
        t = f(i) + f(1.0)
        lr = f(0.01) * f(10.0) ** f(min(i // phase_len, 2))
        out.append((float(lr), float(f(1.0) - f(ADAM_B1) ** t),
                    float(f(1.0) - f(ADAM_B2) ** t)))
    return out


def ascend(p32: DecompProblem, steps: int, init_params=None):
    """The float32 Adam ascent on the per-k bounds from ``init_params``
    (zeros when None); returns the best multipliers seen, the initial point
    included, per k: (lam (n_k,), mu (n_k,), tau (n_k, M)), float32."""
    n_k, M = p32.ks.shape[0], p32.rdv.shape[1]
    dev = p32.rdv.device
    f32 = torch.float32
    if init_params is not None:
        lam0, mu0, tau0 = (torch.as_tensor(x).to(device=dev, dtype=f32) for x in init_params)
        P = torch.cat([lam0.reshape(n_k), mu0.reshape(n_k), tau0.reshape(n_k * M)])
    else:
        P = torch.zeros(n_k * (2 + M), dtype=f32, device=dev)

    def split(x):
        return x[:n_k], x[n_k:2 * n_k], x[2 * n_k:].view(n_k, M)

    if steps <= 0:
        return split(P)
    ar = torch.arange(n_k, device=dev)
    kmap = torch.cat([ar, ar, ar.repeat_interleave(M)])
    cells = None if kernels.on_cuda(p32.rdv) else decomp_cells(p32)
    neg_one = torch.full((n_k,), -1.0, dtype=f32, device=dev)

    b, stats = eval32(p32, *split(P), cells=cells)
    best_b, best_P = b, P
    m = torch.zeros_like(P)
    v = torch.zeros_like(P)
    for lr, bc1, bc2 in _adam_constants(steps):
        g = torch.cat([t.reshape(-1) for t in bound_grads(p32, stats, neg_one)])
        m = ADAM_B1 * m + (1 - ADAM_B1) * g
        v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
        P = P - lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        b, stats = eval32(p32, *split(P), cells=cells)
        better = b > best_b
        best_P = torch.where(better[kmap], P, best_P)
        best_b = torch.maximum(best_b, b)
    return split(best_P)


def decomp_bound_roots(
    p32: DecompProblem,
    p64: DecompProblem,
    rd,
    steps: int,
    init_params=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           Tuple[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Per-k decomposition lower bounds (raw, without ``obj_const``):
    ``(bound, w_star, n_star, y_star, (lam, mu, tau), m_y)`` as
    ``_decomp_bound_roots`` returns them. ``steps`` ascent steps from
    ``init_params`` (the stored duals on a warm tick), then the float64
    evaluation at the chosen multipliers. With ``steps == 0`` only that
    evaluation runs, and the hint (w*, n*, y*) is zeros. ``rd`` is the
    float64 :class:`~distilp_torch.solver.rounding.RoundingData` on the same
    device (for n*)."""
    lam, mu, tau = (x.to(torch.float64) for x in ascend(p32, steps, init_params))
    track_hint = steps > 0
    bound, m_y, _, hint_w, hint_flat = eval64(p64, lam, mu, tau, track_hint)
    n_k, M = tau.shape
    if not track_hint:
        z = torch.zeros((n_k, M), dtype=torch.float64, device=tau.device)
        return bound, z, z, z, (lam, mu, tau), m_y
    w_star, n_star, y_star = primal_hint(rd, hint_w, hint_flat, p64.e_max + 1)
    return bound, w_star, n_star, y_star, (lam, mu, tau), m_y


def primal_hint(rd, hint_w, hint_flat, Y: int):
    """(w*, n*, y*) of the hint cells: y* and the candidate from the flat
    (candidate, y) index, and n* rebuilt from the candidate (0, w, the VRAM
    boundary, the RAM-slack kink or the s <= w endpoint) as
    ``_decomp_bound_roots`` rebuilds it, in float64 from ``rd``."""
    flat = hint_flat.to(torch.int64)
    c_star = flat // Y
    w_star = hint_w
    y_star = (flat % Y).to(torch.float64)
    hg = rd.has_gpu[None, :]
    rm = rd.ram_minus_n[None, :]
    bp = rd.bprime
    zero = torch.zeros((), dtype=torch.float64, device=w_star.device)

    def clip(x, hi):
        return torch.minimum(torch.maximum(x, zero), hi)

    vram_rhs = torch.minimum(rd.cuda_rhs[None, :] - rd.eb_vram[None, :] * y_star,
                             rd.metal_rhs[None, :] - rd.eb_metal[None, :] * y_star)
    n_bnd = clip(torch.floor(vram_rhs / bp), w_star) * hg
    n_bnd = torch.where(torch.isfinite(n_bnd), n_bnd, w_star * hg)
    n_kink = clip(
        torch.ceil((bp * w_star + rd.eb_ram[None, :] * y_star - rd.ram_rhs[None, :]) / bp - 1e-9),
        w_star,
    ) * hg * rm
    n_kink = torch.where(torch.isfinite(n_kink), n_kink, zero)
    n_smin = clip(
        torch.ceil((rd.eb_ram[None, :] * y_star - rd.ram_rhs[None, :]) / bp - 1e-9), w_star
    ) * hg * rm
    n_smin = torch.where(torch.isfinite(n_smin), n_smin, zero)
    n_star = torch.where(
        c_star == 0, zero,
        torch.where(c_star == 1, w_star * hg,
                    torch.where(c_star == 2, n_bnd,
                                torch.where(c_star == 3, n_kink, n_smin))),
    )
    return w_star, n_star, y_star
