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

:func:`ascend` is the Adam ascent of the multipliers. On CUDA tensors it is
one cooperative launch of K7's fused entry (:func:`ascend_fused`: every
step's evaluation, gradient, Adam step and best-of on the card, the lattice
cut into work units over every SM, :func:`unit_plan`); on CPU tensors it is
the plain version, :func:`ascend_stepwise`: a host loop of tensor
operations, one evaluation per step (the evaluation at the new multipliers
gives both the bound for the best-of tracking and the next step's
gradient). On CUDA tensors :func:`ascend_stepwise` launches the float32
entry once a step: ``chip_smoke.py``'s yardstick for the fused launch, on
no path of the solver. :func:`decomp_bound_roots` is the ascent followed by
the float64 evaluation: at most two K7 launches whatever ``steps``.

Several instances at once (a MoE scenario batch, the reference's vmap of
``_decomp_bound_roots``): a :class:`DecompBatch` (:func:`stack_problems`)
carries a leading instance axis S, the multipliers are (S, n_k) and
(S, n_k, M), and every evaluation is one launch over the S instances, so
the S ascents run in lockstep in one host loop. One sweep is the S = 1
batch; a :class:`DecompProblem` is one instance, what the plain versions
evaluate.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import kernels
from ..obs.compile_ledger import instrument as _instrument

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
# Adam's constants as torch's float32 operations take the Python scalars
# (b1, 1 - b1, b2, 1 - b2, eps): the fused ascent's arguments.
ADAM_F32 = tuple(float(np.float32(x)) for x in
                 (ADAM_B1, 1 - ADAM_B1, ADAM_B2, 1 - ADAM_B2, ADAM_EPS))
# Blocks per SM the fused ascent's grid may take (at most what the card
# holds co-resident, itself capped at 4 by the library): each unit is one
# block, every block meets every grid sync and folds its owner's M n_chunks
# slots each step, so more chunks cost more than they spread.
# chip_k7_profile.py times 1 to 4; 2 was the fastest or level on every
# instance it times.
ASCENT_BLOCKS_PER_SM = 2
# Blocks per SM the float64 evaluation's work units aim at, and the fewest
# (w, y) pairs a unit of either entry takes when its row has them (two a
# thread of the ascent's 256-thread blocks).
F64_BLOCKS_PER_SM = 2
UNIT_MIN_PAIRS = 512


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


class DecompBatch(NamedTuple):
    """S sweeps' decomposition data in one dtype, on one device (the same
    k-grid length, ``w_max`` and ``e_max``)."""

    rdv: torch.Tensor  # (S, 15, M)
    bp: torch.Tensor  # (S,)
    E: torch.Tensor  # (S,)
    ks: torch.Tensor  # (S, n_k)
    Ws: torch.Tensor  # (S, n_k)
    w_max: int
    e_max: int

    @property
    def dtype(self):
        return self.rdv.dtype

    def instance(self, s: int) -> DecompProblem:
        return DecompProblem(rdv=self.rdv[s], bp=float(self.bp[s]), E=float(self.E[s]),
                             ks=self.ks[s], Ws=self.Ws[s], w_max=self.w_max,
                             e_max=self.e_max)


def stack_problems(problems) -> DecompBatch:
    """One :class:`DecompBatch` of single-sweep problems."""
    p0 = problems[0]
    if any((p.w_max, p.e_max, p.ks.shape) != (p0.w_max, p0.e_max, p0.ks.shape)
           for p in problems):
        raise ValueError("stacked decomposition problems need one k grid, w_max and e_max")
    dev, dt = p0.rdv.device, p0.dtype
    return DecompBatch(
        rdv=torch.stack([p.rdv for p in problems]).contiguous(),
        bp=torch.tensor([p.bp for p in problems], dtype=dt, device=dev),
        E=torch.tensor([p.E for p in problems], dtype=dt, device=dev),
        ks=torch.stack([p.ks for p in problems]).contiguous(),
        Ws=torch.stack([p.Ws for p in problems]).contiguous(),
        w_max=p0.w_max,
        e_max=p0.e_max,
    )


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


def _check_inputs(p: DecompBatch, lam, mu, theta, dtype):
    """(S, n_k, M) of a kernel call; raises on what the kernel does not
    take."""
    S, n_k, M = theta.shape
    if p.dtype != dtype or any(t.dtype != dtype for t in (lam, mu, theta, p.bp, p.E)):
        raise TypeError(f"this decomposition evaluation takes {dtype} tensors")
    if p.rdv.shape != (S, len(RD_DEV_FIELDS), M) or p.ks.shape != (S, n_k) \
            or lam.shape != (S, n_k) or mu.shape != (S, n_k) or p.bp.shape != (S,):
        raise ValueError("decomposition inputs do not match (S, n_k, M)")
    return S, n_k, M


def eval32_kernel(p: DecompBatch, lam, mu, theta):
    """K7's float32 entry on CUDA tensors: what :func:`eval32_reference`
    returns, at ``theta`` = (k - 1) softmax(tau), for every instance of
    ``p`` in one launch (each value with the leading instance axis)."""
    from ..kernels.build import library

    S, n_k, M = _check_inputs(p, lam, mu, theta, torch.float32)
    dev = p.rdv.device
    outs = [torch.empty((S, n_k, M), dtype=torch.float32, device=dev) for _ in range(4)]
    # Held until the launch (a temporary freed inside the argument list could
    # hand its memory to the next one).
    ins = [t.contiguous() for t in (p.rdv, p.bp, p.E, p.ks, p.Ws, lam, mu, theta)]
    P = kernels.ptr
    err = library("decomp").dtk_decomp_eval_f32(
        *[P(t) for t in ins[:5]], S, n_k, M, p.w_max, p.e_max,
        *[P(t) for t in ins[5:]], *[P(o) for o in outs], kernels.stream_handle(dev),
    )
    kernels.check(err, "decomp")
    kernels.count_launch("decomp_lanes" if S > 1 else "decomp", "eval32")
    return tuple(outs)


class UnitPlan(NamedTuple):
    """K7's work units: each (instance, k, device) row's layers w in
    ``n_chunks`` chunks of ``chunk_w`` (the last one shorter), ``units`` =
    rows x chunks, one Acc slot each; ``grid`` the blocks of the launch."""

    chunk_w: int
    n_chunks: int
    units: int
    grid: int


def unit_plan(S: int, n_k: int, M: int, w_max: int, e_max: int, target: int) -> UnitPlan:
    """Cut the S n_k M rows' w ranges so the units come as close to
    ``target`` blocks as whole chunks allow without passing it (every row at
    least one chunk, every chunk at least one w and, where the row has
    them, :data:`UNIT_MIN_PAIRS` (w, y) pairs). ``grid`` is the units,
    capped at ``target``."""
    rows = S * n_k * M
    n_chunks = max(1, min(w_max, target // rows, w_max * (e_max + 1) // UNIT_MIN_PAIRS))
    chunk_w = -(-w_max // n_chunks)
    n_chunks = -(-w_max // chunk_w)
    units = rows * n_chunks
    return UnitPlan(chunk_w, n_chunks, units, max(1, min(target, units)))


def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def eval64_kernel(p: DecompBatch, lam, mu, theta, track_hint: bool):
    """K7's float64 entry on CUDA tensors: what :func:`eval64_reference`
    returns, for every instance of ``p`` in one launch of work units (each
    row's w range in chunks over the SMs; the last unit of a row folds its
    partials in chunk order)."""
    from ..kernels.build import library

    S, n_k, M = _check_inputs(p, lam, mu, theta, torch.float64)
    dev = p.rdv.device
    Y = p.e_max + 1
    plan = unit_plan(S, n_k, M, p.w_max, p.e_max, F64_BLOCKS_PER_SM * _sm_count(dev))
    lib = library("decomp")
    ws = torch.empty(int(lib.dtk_decomp_f64_ws_bytes(plan.units, Y)), dtype=torch.uint8,
                     device=dev)
    count = torch.zeros(S * n_k * M, dtype=torch.int32, device=dev)
    m_y = torch.empty((S, n_k, M, Y), dtype=torch.float64, device=dev)
    any_ok = torch.empty((S, n_k, M), dtype=torch.uint8, device=dev)
    hint_w = torch.zeros((S, n_k, M), dtype=torch.float64, device=dev)
    hint_flat = torch.zeros((S, n_k, M), dtype=torch.int32, device=dev)
    ins = [t.contiguous() for t in (p.rdv, p.bp, p.E, p.ks, p.Ws, lam, mu, theta)]
    P = kernels.ptr
    err = lib.dtk_decomp_eval_f64(
        *[P(t) for t in ins[:5]], S, n_k, M, p.w_max, p.e_max,
        *[P(t) for t in ins[5:]], int(track_hint), plan.chunk_w, plan.n_chunks, P(ws),
        ws.numel(), P(count), P(m_y), P(any_ok), P(hint_w), P(hint_flat),
        kernels.stream_handle(dev),
    )
    kernels.check(err, "decomp")
    kernels.count_launch("decomp_lanes" if S > 1 else "decomp", "eval64")
    return m_y, any_ok.to(torch.bool), hint_w, hint_flat


def _reference_by_instance(fn, p: DecompBatch, lam, mu, theta, *args, cells=None):
    """A plain single-problem evaluation over every instance of a batch,
    stacked (``cells``: one :func:`decomp_cells` per instance, or None)."""
    S = p.rdv.shape[0]
    extra = [() if cells is None else (cells[s],) for s in range(S)]
    outs = [fn(p.instance(s), lam[s], mu[s], theta[s], *args, *extra[s]) for s in range(S)]
    return tuple(torch.stack(x) for x in zip(*outs))


# ------------------------------------------------------------ evaluations


def softmax(tau: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(tau, axis=-1)`` as it computes it."""
    e = torch.exp(tau - tau.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def eval32(p: DecompBatch, lam, mu, tau, cells=None):
    """(b (S, n_k), stats) of the float32 bound at (lam, mu, tau) (S, n_k),
    (S, n_k), (S, n_k, M); ``stats`` = (w_bar, y_bar, cyc_bar, softmax(tau))
    feeds :func:`bound_grads`. The kernel evaluates all instances in one
    launch; ``cells`` (one :func:`decomp_cells` per instance) saves the
    plain version rebuilding them."""
    s = softmax(tau)
    theta = (p.ks - 1.0)[..., None] * s
    if kernels.on_cuda(p.rdv, lam, mu, tau):
        mn, wbar, ybar, cycbar = eval32_kernel(p, lam, mu, theta)
    else:
        mn, wbar, ybar, cycbar = _reference_by_instance(eval32_reference, p, lam, mu, theta,
                                                        cells=cells)
    b = mn.sum(dim=-1) + lam * p.Ws + mu * p.E[:, None]
    return b, (wbar, ybar, cycbar, s)


def bound_grads(p: DecompBatch, stats, grad_b):
    """Gradients of sum(grad_b * b) with respect to (lam, mu, tau)."""
    wbar, ybar, cycbar, s = stats
    g_lam = grad_b * (p.Ws - wbar.sum(dim=-1))
    g_mu = grad_b * (p.E[:, None] - ybar.sum(dim=-1))
    ct_s = (p.ks - 1.0)[..., None] * (grad_b[..., None] * cycbar)
    g_tau = s * ct_s - s * (s * ct_s).sum(dim=-1, keepdim=True)
    return g_lam, g_mu, g_tau


class DecompBound32(torch.autograd.Function):
    """b = bound(lam, mu, tau) in float32 (:func:`eval32`), differentiable:
    the backward pass spreads each (k, device)'s cotangent equally over its
    tied minimizing cells."""

    @staticmethod
    def forward(ctx, lam, mu, tau, problem: DecompBatch):
        b, stats = eval32(problem, lam, mu, tau)
        ctx.problem = problem
        ctx.stats = stats
        return b

    @staticmethod
    def backward(ctx, grad_b):
        g_lam, g_mu, g_tau = bound_grads(ctx.problem, ctx.stats, grad_b)
        return g_lam, g_mu, g_tau, None


def eval64(p: DecompBatch, lam, mu, tau, track_hint: bool):
    """The float64 evaluation at (lam, mu, tau): (bound (S, n_k), m_y,
    any_ok, hint_w, hint_flat), each with the leading instance axis. The
    bound is -inf where it is NaN and +inf for a k in which some device has
    no feasible cell. On CUDA tensors three launches: the theta fold, K7's
    float64 entry and the bound fold (the loop's graph runs the same three,
    so both routes' bounds agree bit for bit)."""
    if kernels.on_cuda(p.rdv, lam, mu, tau):
        theta = theta_kernel(p.ks, tau)
        m_y, any_ok, hint_w, hint_flat = eval64_kernel(p, lam, mu, theta, track_hint)
        return bound_kernel(p, m_y, any_ok, lam, mu), m_y, any_ok, hint_w, hint_flat
    theta = (p.ks - 1.0)[..., None] * softmax(tau)
    m_y, any_ok, hint_w, hint_flat = _reference_by_instance(
        eval64_reference, p, lam, mu, theta, track_hint)
    return bound_of(p, m_y, any_ok, lam, mu), m_y, any_ok, hint_w, hint_flat


def theta_kernel(ks, tau):
    """K7's theta fold on CUDA tensors: (k - 1) softmax(tau), (S, n_k, M)
    float64 from ``ks`` (S, n_k) and ``tau``, the devices summed in order
    (the plain version: ``(ks - 1)[..., None] * softmax(tau)``)."""
    from ..kernels.build import library

    S, n_k, M = tau.shape
    if ks.dtype != torch.float64 or tau.dtype != torch.float64 or ks.shape != (S, n_k):
        raise TypeError("the theta fold takes float64 ks (S, n_k) and tau (S, n_k, M)")
    ins = [ks.contiguous(), tau.contiguous()]
    theta = torch.empty((S, n_k, M), dtype=torch.float64, device=tau.device)
    P, O = kernels.ptr, kernels.opt_ptr
    err = library("decomp").dtk_decomp_theta_f64(
        O(None), P(ins[1]), P(ins[0]), S, n_k, M, O(None), O(None), O(None), P(theta),
        kernels.stream_handle(tau.device))
    kernels.check(err, "decomp_theta")
    kernels.count_launch("decomp_theta")
    return theta


def bound_kernel(p: DecompBatch, m_y, any_ok, lam, mu):
    """K7's bound fold on CUDA tensors: :func:`bound_of` with the devices
    summed in order."""
    from ..kernels.build import library

    S, n_k, M, Y = m_y.shape
    if any(t.dtype != torch.float64 for t in (m_y, lam, mu, p.Ws, p.E)):
        raise TypeError("the bound fold takes float64 tensors")
    ins = [m_y.contiguous(), any_ok.to(torch.uint8).contiguous(), lam.contiguous(),
           mu.contiguous(), p.Ws.contiguous(), p.E.contiguous()]
    out = torch.empty((S, n_k), dtype=torch.float64, device=m_y.device)
    P = kernels.ptr
    err = library("decomp").dtk_decomp_bound_f64(
        *[P(t) for t in ins], S, n_k, M, Y, P(out), kernels.stream_handle(m_y.device))
    kernels.check(err, "decomp_bound")
    kernels.count_launch("decomp_bound")
    return out


def bound_of(p: DecompBatch, m_y, any_ok, lam, mu) -> torch.Tensor:
    """The per-k bound (S, n_k) from the y-profile: sum over devices of the
    minimum over y, plus lam W + mu E; -inf where NaN, +inf for a k in which
    some device has no feasible cell."""
    bound = m_y.amin(dim=-1).sum(dim=-1) + lam * p.Ws + mu * p.E[:, None]
    bound = torch.where(torch.isnan(bound), float("-inf"), bound)
    return torch.where(any_ok.all(dim=-1), bound, float("inf"))


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


def _initial_params(p32: DecompBatch, init_params):
    """The ascent's starting point as one (S, n_k (2 + M)) float32 tensor:
    lam, mu, tau of each instance, zeros when ``init_params`` is None."""
    S, n_k = p32.ks.shape
    M = p32.rdv.shape[-1]
    dev = p32.rdv.device
    f32 = torch.float32
    if init_params is None:
        return torch.zeros((S, n_k * (2 + M)), dtype=f32, device=dev)
    lam0, mu0, tau0 = (torch.as_tensor(x).to(device=dev, dtype=f32) for x in init_params)
    return torch.cat([lam0.reshape(S, n_k), mu0.reshape(S, n_k),
                      tau0.reshape(S, n_k * M)], dim=-1)


def _split_params(P, n_k: int, M: int):
    """(lam (S, n_k), mu (S, n_k), tau (S, n_k, M)) of a packed ``P``."""
    return P[..., :n_k], P[..., n_k:2 * n_k], P[..., 2 * n_k:].reshape(-1, n_k, M)


def ascend(p32: DecompBatch, steps: int, init_params=None):
    """The float32 Adam ascent on the per-k bounds from ``init_params``
    (zeros when None); returns the best multipliers seen, the initial point
    included, per (instance, k): (lam (S, n_k), mu (S, n_k), tau
    (S, n_k, M)), float32. The S ascents run in lockstep, as the
    reference's vmap runs them. CUDA tensors: one launch of K7's fused
    entry (:func:`ascend_fused`); CPU tensors: :func:`ascend_stepwise`."""
    if kernels.on_cuda(p32.rdv):
        return ascend_fused(p32, steps, init_params)
    return ascend_stepwise(p32, steps, init_params)


def ascend_stepwise(p32: DecompBatch, steps: int, init_params=None):
    """The ascent as a host loop of tensor operations, one float32
    evaluation of all S instances per step (:func:`eval32`) and none read
    back: the plain version on CPU tensors; on CUDA tensors a K7 launch a
    step (the card's yardstick of :func:`ascend_fused`)."""
    S, n_k = p32.ks.shape
    M = p32.rdv.shape[-1]
    dev = p32.rdv.device
    f32 = torch.float32
    P = _initial_params(p32, init_params)

    def split(x):
        return _split_params(x, n_k, M)

    if steps <= 0:
        return split(P)
    ar = torch.arange(n_k, device=dev)
    kmap = torch.cat([ar, ar, ar.repeat_interleave(M)])
    cells = None
    if not kernels.on_cuda(p32.rdv):
        cells = [decomp_cells(p32.instance(i)) for i in range(S)]
    neg_one = torch.full((S, n_k), -1.0, dtype=f32, device=dev)

    b, stats = eval32(p32, *split(P), cells=cells)
    best_b, best_P = b, P
    m = torch.zeros_like(P)
    v = torch.zeros_like(P)
    for lr, bc1, bc2 in _adam_constants(steps):
        g = torch.cat([t.reshape(S, -1) for t in bound_grads(p32, stats, neg_one)], dim=-1)
        m = ADAM_B1 * m + (1 - ADAM_B1) * g
        v = ADAM_B2 * v + (1 - ADAM_B2) * g * g
        P = P - lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS)
        b, stats = eval32(p32, *split(P), cells=cells)
        better = b > best_b
        best_P = torch.where(better[..., kmap], P, best_P)
        best_b = torch.maximum(best_b, b)
    return split(best_P)


@functools.lru_cache(maxsize=64)
def _adam_table(steps: int, device: str) -> torch.Tensor:
    """:func:`_adam_constants` as a (steps, 3) float32 tensor on ``device``,
    uploaded once per process."""
    return torch.tensor(_adam_constants(steps), dtype=torch.float32, device=device)


@functools.lru_cache(maxsize=64)
def _ascent_grid(device: str, M: int, per_block: int) -> int:
    """Blocks of the fused ascent the card holds co-resident at M devices
    when each block keeps ``per_block`` owner states in shared memory (0:
    in global memory); 0 where not even one block fits."""
    from ..kernels.build import library

    with torch.cuda.device(torch.device(device)):
        g = int(library("decomp").dtk_decomp_ascent_grid(M, per_block))
    return max(g, 0)


def ascent_layout(S: int, n_k: int, M: int, w_max: int, e_max: int, sms: int, grid_at):
    """(plan, per_block) of the fused ascent: :func:`unit_plan` towards
    :data:`ASCENT_BLOCKS_PER_SM` blocks an SM (fewer where a block holding
    one owner state does not fit that often), and the owner states each
    block keeps in shared memory, ceil(units / grid), or 0 (one state a
    unit in global memory) where shared memory cannot hold that many at
    the plan's grid. ``grid_at(per_block)`` is the card's co-resident
    blocks at that size (:func:`_ascent_grid`)."""
    target = min(grid_at(1), ASCENT_BLOCKS_PER_SM * sms)
    if target < 1:
        raise RuntimeError(f"decomp ascent: no block fits the card at M={M}")
    plan = unit_plan(S, n_k, M, w_max, e_max, target)
    per_block = -(-plan.units // plan.grid)
    if grid_at(per_block) < plan.grid:
        per_block = 0
    return plan, per_block


def ascend_fused(p32: DecompBatch, steps: int, init_params=None):
    """K7's fused entry on CUDA tensors: the whole ascent of
    :func:`ascend_stepwise` in one cooperative launch (none when ``steps``
    <= 0), each evaluation over :func:`unit_plan`'s work units on every SM
    (a block each), then one grid sync, after which every block takes the
    gradient, the Adam step (``_adam_constants``' per-step table) and the
    best-of of its units' (instance, k) on its own copy of their
    multipliers (:func:`ascent_layout`: in shared memory, or one a unit in
    global memory for batches whose copies shared memory cannot hold), the
    cells priced once per call into the workspace."""
    from ..kernels.build import library

    S, n_k = p32.ks.shape
    M = p32.rdv.shape[-1]
    P0 = _initial_params(p32, init_params)
    if steps <= 0:
        return _split_params(P0, n_k, M)
    _check_inputs(p32, *_split_params(P0, n_k, M), torch.float32)
    dev = p32.rdv.device
    lib = library("decomp")
    plan, per_block = ascent_layout(S, n_k, M, p32.w_max, p32.e_max, _sm_count(dev),
                                    functools.partial(_ascent_grid, str(dev), M))
    n_cells = S * n_k * M * p32.w_max * (p32.e_max + 1) * N_CANDS
    ws = torch.empty(int(lib.dtk_decomp_ascent_ws_bytes(plan.units, n_cells, M, per_block)),
                     dtype=torch.uint8, device=dev)
    best = torch.empty_like(P0)
    adam = _adam_table(steps, str(dev))
    ins = [t.contiguous() for t in (p32.rdv, p32.bp, p32.E, p32.ks, p32.Ws)]
    P = kernels.ptr
    err = lib.dtk_decomp_ascent_f32(
        *[P(t) for t in ins], S, n_k, M, p32.w_max, p32.e_max, P(adam), steps, *ADAM_F32,
        P(P0), plan.chunk_w, plan.n_chunks, plan.grid, per_block, P(ws), ws.numel(),
        P(best), kernels.stream_handle(dev),
    )
    kernels.check(err, "decomp ascent")
    kernels.count_launch("decomp_lanes" if S > 1 else "decomp", "ascent")
    return _split_params(best, n_k, M)


def decomp_bound_roots(
    p32: DecompBatch,
    p64: DecompBatch,
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
    float64 stack of the instances'
    :class:`~distilp_torch.solver.rounding.RoundingData` on the same device
    (for n*). Every output carries the leading instance axis. On CUDA
    tensors: two K7 launches (the fused ascent, the float64 evaluation),
    one with ``steps == 0``."""
    lam, mu, tau = (x.to(torch.float64) for x in ascend(p32, steps, init_params))
    track_hint = steps > 0
    bound, m_y, _, hint_w, hint_flat = eval64(p64, lam, mu, tau, track_hint)
    if not track_hint:
        z = torch.zeros(tau.shape, dtype=torch.float64, device=tau.device)
        return bound, z, z, z, (lam, mu, tau), m_y
    w_star, n_star, y_star = primal_hint(rd, hint_w, hint_flat, p64.e_max + 1)
    return bound, w_star, n_star, y_star, (lam, mu, tau), m_y


decomp_bound_roots = _instrument("ops.decomp.decomp_bound_roots", decomp_bound_roots)


def primal_hint(rd, hint_w, hint_flat, Y: int):
    """(w*, n*, y*) of the hint cells: y* and the candidate from the flat
    (candidate, y) index, and n* rebuilt from the candidate (0, w, the VRAM
    boundary, the RAM-slack kink or the s <= w endpoint) as
    ``_decomp_bound_roots`` rebuilds it, in float64 from ``rd`` ((n_k, M)
    hints of one instance, or (S, n_k, M) of a stack of S)."""
    flat = hint_flat.to(torch.int64)
    c_star = flat // Y
    w_star = hint_w
    y_star = (flat % Y).to(torch.float64)

    def dev_(x):  # a per-device vector against the (…, n_k, M) hints
        return x[..., None, :]

    hg = dev_(rd.has_gpu)
    rm = dev_(rd.ram_minus_n)
    bp = rd.bprime[..., None, None]
    zero = torch.zeros((), dtype=torch.float64, device=w_star.device)

    def clip(x, hi):
        return torch.minimum(torch.maximum(x, zero), hi)

    vram_rhs = torch.minimum(dev_(rd.cuda_rhs) - dev_(rd.eb_vram) * y_star,
                             dev_(rd.metal_rhs) - dev_(rd.eb_metal) * y_star)
    n_bnd = clip(torch.floor(vram_rhs / bp), w_star) * hg
    n_bnd = torch.where(torch.isfinite(n_bnd), n_bnd, w_star * hg)
    n_kink = clip(
        torch.ceil((bp * w_star + dev_(rd.eb_ram) * y_star - dev_(rd.ram_rhs)) / bp - 1e-9),
        w_star,
    ) * hg * rm
    n_kink = torch.where(torch.isfinite(n_kink), n_kink, zero)
    n_smin = clip(
        torch.ceil((dev_(rd.eb_ram) * y_star - dev_(rd.ram_rhs)) / bp - 1e-9), w_star
    ) * hg * rm
    n_smin = torch.where(torch.isfinite(n_smin), n_smin, zero)
    n_star = torch.where(
        c_star == 0, zero,
        torch.where(c_star == 1, w_star * hg,
                    torch.where(c_star == 2, n_bnd,
                                torch.where(c_star == 3, n_kink, n_smin))),
    )
    return w_star, n_star, y_star
