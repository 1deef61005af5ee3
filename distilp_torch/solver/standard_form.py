"""Host-side (numpy) boxed standard form of the HALDA LP family.

The search constants and budgets, the exact rounding data, and the row-scaled
per-k ``(A, b, c, lo, hi)`` family the branch-and-bound sweep solves. The
arrays are numpy and byte-equal to what the JAX package builds
(``distilp_tpu/solver/backend_jax.py``: ``default_search_params``,
``default_pdhg_iters``, ``_resolve_lp_backend``, ``_resolve_search_params``,
``_rounding_arrays_np``, ``_root_boxes``, ``build_standard_form``), which the
tests pin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..ops.pdhg import resolve_pdhg_dtype
from .assemble import INACTIVE_RHS, MilpArrays
from .coeffs import HaldaCoeffs

# Fixed frontier capacity of the escalated (MoE-class) budget.
NODE_CAP = 256
MAX_ROUNDS = 48
IPM_ITERS = 26
FRAC_TOL = 1e-4
# Frontier rows that get an LP solve per round in the escalated budget.
BEAM = 16
# Greedy expert-move steps that polish a rounded MoE incumbent: cold solves
# and Lagrangian-primal repairs take the full budget, a warm tick's
# re-pricing of last tick's optimum a short one.
MOE_LOCAL_MOVES = 8
MOE_LOCAL_MOVES_WARM = 2
# Lagrangian root-ascent budgets: a cold MoE solve runs the full ascent; a
# warm tick that carries the previous multipliers only re-evaluates the
# bound at them (valid at any multiplier vector, so staleness costs
# tightness, never soundness).
DECOMP_STEPS_COLD = 300
DECOMP_STEPS_WARM = 0

# LP relaxation engines: 'ipm' (batched Mehrotra, dense m x m normal
# matrices), 'pdhg' (matrix-free restarted Halpern PDHG, the fleet-scale
# engine) and 'auto' (pdhg at or above PDHG_AUTO_M devices, ipm below).
LP_BACKENDS = ("ipm", "pdhg", "auto")
PDHG_AUTO_M = 128
# First-order budgets: a PDHG step is two matvecs, so budgets are ~2 orders
# of magnitude above the IPM's; warm rounds keep a quarter of the cold one.
PDHG_ITERS = 2000
PDHG_WARM_FLOOR = 200


def default_pdhg_iters(M: int) -> int:
    """Size-aware cold first-order budget (the escalation ladder multiplies
    this one copy of the rule)."""
    return PDHG_ITERS * max(1, M // 128)


def resolve_lp_backend(lp_backend: Optional[str], M: int) -> str:
    """'ipm' or 'pdhg' from the public selector (None = 'auto')."""
    lb = "auto" if lp_backend is None else lp_backend
    if lb not in LP_BACKENDS:
        raise ValueError(
            f"unknown lp_backend {lp_backend!r}; expected one of {LP_BACKENDS}"
        )
    if lb == "auto":
        return "pdhg" if M >= PDHG_AUTO_M else "ipm"
    return lb


def default_search_params(moe: bool, n_k: int) -> Tuple[int, int, int]:
    """(node_cap, beam, ipm_iters) defaults by problem class."""
    if moe:
        return NODE_CAP, BEAM, IPM_ITERS
    return max(64, 2 * n_k), 6, 8


def resolve_search_params(
    moe: bool,
    n_k: int,
    node_cap: Optional[int],
    beam: Optional[int],
    ipm_iters: Optional[int],
    max_rounds: Optional[int],
    ipm_warm_iters: Optional[int] = None,
    lp_backend: Optional[str] = None,
    pdhg_iters: Optional[int] = None,
    M: int = 0,
    mesh_shards: Optional[int] = None,
    pdhg_dtype: Optional[str] = None,
    per_k: bool = False,
) -> Tuple[int, int, int, int, int, str, int, Optional[str]]:
    """(cap, beam, lp_iters, lp_warm_iters, max_rounds, engine, mesh_shards,
    pdhg_dtype): caller overrides over the problem-class defaults.

    Under 'ipm' every round after the root warm-starts from its parent, so
    its budget defaults to half the cold one (at least 6). Under 'pdhg' the
    iteration slots carry the first-order budgets (``pdhg_iters``, else
    :func:`default_pdhg_iters`; warm rounds a quarter of it, at least
    ``PDHG_WARM_FLOOR``); ``ipm_iters``/``ipm_warm_iters`` do not touch a
    PDHG solve. ``mesh_shards`` and ``pdhg_dtype`` are PDHG knobs: set while
    the engine resolved to the IPM, they raise. A truncated budget only
    loosens the float64 bound.

    Per-k mode keeps every k's subtree alive to its own certificate, so the
    frontier carries ~n_k searches at once: the default capacity is at least
    32 n_k and the default beam at least 4 n_k.
    """
    d_cap, d_beam, d_iters = default_search_params(moe, n_k)
    if per_k:
        d_cap = max(d_cap, 32 * n_k)
        d_beam = max(d_beam, 4 * n_k)
    engine = resolve_lp_backend(lp_backend, M)
    if engine == "pdhg":
        it = pdhg_iters if pdhg_iters is not None else default_pdhg_iters(M)
        warm_it = min(it, max(PDHG_WARM_FLOOR, it // 4))
    else:
        it = ipm_iters if ipm_iters is not None else d_iters
        warm_it = ipm_warm_iters if ipm_warm_iters is not None else max(6, it // 2)
        warm_it = min(warm_it, it) if ipm_warm_iters is None else warm_it
    shards = 1 if mesh_shards is None else int(mesh_shards)
    if shards < 1:
        raise ValueError(f"mesh_shards must be >= 1 (got {mesh_shards})")
    resolve_pdhg_dtype(pdhg_dtype)  # validate the spelling early
    if engine != "pdhg":
        if shards > 1:
            raise ValueError(
                f"mesh_shards={shards} requires the matrix-free pdhg "
                f"engine, but lp_backend resolved to {engine!r} (pass "
                f"lp_backend='pdhg', or 'auto' at fleet scale)"
            )
        if pdhg_dtype is not None:
            raise ValueError(
                f"pdhg_dtype={pdhg_dtype!r} is a pdhg-engine knob, but "
                f"lp_backend resolved to {engine!r}"
            )
    return (
        max(node_cap, n_k) if node_cap is not None else d_cap,
        beam if beam is not None else d_beam,
        it,
        warm_it,
        max_rounds if max_rounds is not None else MAX_ROUNDS,
        engine,
        shards,
        pdhg_dtype,
    )


# Rounding-data vectors, in the order the rounding kernel packs them (the
# first twelve; the MoE vectors are zeros in dense mode).
RD_VEC_FIELDS = (
    "a",
    "b_gpu",
    "pen_set",
    "pen_vram",
    "busy_const",
    "s_disk",
    "ram_rhs",
    "ram_minus_n",
    "cuda_rhs",
    "metal_rhs",
    "has_gpu",
    "w_active",
    "g_raw",
    "eb_ram",
    "eb_vram",
    "eb_metal",
)


def rounding_arrays_np(coeffs: HaldaCoeffs, moe=None) -> dict:
    """Exact (float64) per-device MILP data of the rounding heuristic."""
    M = coeffs.M
    pen_by_set = np.where(
        coeffs.set_id == 1,
        coeffs.pen_m1,
        np.where(coeffs.set_id == 2, coeffs.pen_m2, coeffs.pen_m3),
    )
    return dict(
        a=np.asarray(coeffs.a, np.float64),
        b_gpu=np.asarray(coeffs.b_gpu, np.float64),
        pen_set=np.asarray(pen_by_set, np.float64),
        pen_vram=np.asarray(coeffs.pen_vram, np.float64),
        busy_const=np.asarray(coeffs.busy_const, np.float64),
        s_disk=np.asarray(coeffs.s_disk, np.float64),
        ram_rhs=np.where(np.isfinite(coeffs.ram_rhs), coeffs.ram_rhs, INACTIVE_RHS),
        ram_minus_n=coeffs.ram_minus_n.astype(np.float64),
        cuda_rhs=np.where(coeffs.cuda_row, coeffs.cuda_rhs, np.inf),
        metal_rhs=np.where(coeffs.metal_row, coeffs.metal_rhs, np.inf),
        has_gpu=coeffs.has_gpu.astype(np.float64),
        g_raw=np.asarray(moe.g_raw if moe is not None else np.zeros(M), np.float64),
        eb_ram=np.asarray(
            moe.eb_ram if moe is not None else np.zeros(M), np.float64
        ),
        eb_vram=np.asarray(
            moe.eb_vram if moe is not None else np.zeros(M), np.float64
        ),
        eb_metal=np.asarray(
            moe.eb_metal if moe is not None else np.zeros(M), np.float64
        ),
        w_active=np.asarray(
            getattr(coeffs, "w_active", None)
            if getattr(coeffs, "w_active", None) is not None
            else np.ones(M),
            np.float64,
        ),
        bprime=np.float64(coeffs.bprime),
        E=np.float64(moe.E if moe is not None else 0.0),
    )


@dataclass
class StandardForm:
    """Host-assembled arrays of the boxed-standard-form LP family.

    Variables: [x_struct (N) | row slacks (6M)]; rows: 6M scaled inequality
    rows turned equalities + the sum(w)=W equality. In dense mode A is
    k-independent, so exactly one copy is built (leading axis length 1).
    ``A_base``/``smin_k``/``C_ub_k`` are what the device materialization
    starts from: the slack boxes and the cycle-time box are recomputed there
    in float32, as the reference's device program does.
    """

    A: np.ndarray  # (n_k, m, nf) row-scaled; (1, m, nf) in dense mode
    b_k: np.ndarray  # (n_k, m)
    c_k: np.ndarray  # (n_k, nf)
    lo_k: np.ndarray  # (n_k, nf) root boxes
    hi_k: np.ndarray  # (n_k, nf)
    int_mask: np.ndarray  # (nf,) bool — branchable columns
    ks: List[int]
    Ws: List[int]
    M: int
    obj_const: float
    moe: bool = False
    A_base: Optional[np.ndarray] = None  # (m, nf) scaled, g entries zero
    smin_k: Optional[np.ndarray] = None  # (n_k, m_ub) slack-box row minima
    C_ub_k: Optional[np.ndarray] = None  # (n_k,) cycle-time upper bound
    gscale: Optional[np.ndarray] = None  # (2, M) MoE row scales, else None


def root_boxes(
    arrays: MilpArrays, rd: dict, k: int, W: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Finite boxes for every variable at one k.

    z and C are nominally free above, but any optimal solution satisfies
    z_i <= F_i^max and C <= max_i(B_i^max + F_i^max); boxing everything is
    what makes the Lagrangian bound rigorous for any dual vector.
    """
    lay = arrays.layout
    M = lay.M
    lo, hi = arrays.bounds_for_k(W)

    F_max = W * rd["bprime"] / rd["s_disk"]
    s_cap = float(W)  # slack counts streamable LAYERS; experts get no slack
    B_max = (
        rd["a"] * W
        + np.maximum(rd["b_gpu"], 0.0) * W
        + rd["pen_set"] * s_cap
        + rd["pen_vram"] * W * rd["has_gpu"]
        + (rd["g_raw"] / float(k)) * rd["E"]
        + rd["busy_const"]
    )
    z_ub = F_max
    C_ub = float(np.max(B_max + F_max)) if M else 1.0

    hi = hi.copy()
    hi[lay.z0 : lay.C] = z_ub
    hi[lay.C] = C_ub
    return lo, hi


def build_standard_form(
    arrays: MilpArrays, coeffs: HaldaCoeffs, kWs: Sequence[Tuple[int, int]]
) -> StandardForm:
    """Row-scale the MILP and emit the per-k (A, b, c, box) family.

    Row scaling is computed from the g-zeroed base matrix, so it is
    k-independent; each inequality row (with its inactive RHS) is normalized
    by its own magnitude and its slack column keeps coefficient 1.
    """
    lay = arrays.layout
    M = lay.M
    N = lay.n_vars
    n_eq = lay.n_eq
    m_ub = arrays.A_ub.shape[0]
    nf = N + m_ub
    m = m_ub + n_eq

    rd = rounding_arrays_np(coeffs, arrays.moe)

    row_mag = np.maximum(np.abs(arrays.A_ub).max(axis=1), np.abs(arrays.b_ub))
    row_scale = 1.0 / np.maximum(row_mag, 1.0)

    A_base = np.zeros((m, nf))
    A_base[:m_ub, :N] = arrays.A_ub * row_scale[:, None]
    A_base[:m_ub, N:] = np.eye(m_ub)
    A_base[m_ub:, :N] = arrays.A_eq
    b_ub_scaled = arrays.b_ub * row_scale

    n_k = len(kWs)
    A = np.zeros((n_k if lay.moe else 1, m, nf))
    b_k = np.zeros((n_k, m))
    c_k = np.zeros((n_k, nf))
    lo_k = np.zeros((n_k, nf))
    hi_k = np.zeros((n_k, nf))
    smin_k = np.zeros((n_k, m_ub))
    C_ub_k = np.zeros(n_k)

    g_raw = rd["g_raw"]
    for j, (k, W) in enumerate(kWs):
        ja = j if lay.moe else 0
        if lay.moe:
            A[ja] = A_base
            for i in range(M):
                g_k = g_raw[i] / float(k)
                A[ja, 4 * M + i, lay.y(i)] = g_k * row_scale[4 * M + i]
                A[ja, 5 * M + i, lay.y(i)] = g_k * row_scale[5 * M + i]
        elif j == 0:
            A[0] = A_base

        b_k[j, :m_ub] = b_ub_scaled
        b_k[j, m_ub:] = arrays.b_eq_for_k(W)
        c_k[j, :N] = arrays.c_for_k(k)

        lo_s, hi_s = root_boxes(arrays, rd, k, W)
        lo_k[j, :N] = lo_s
        hi_k[j, :N] = hi_s
        C_ub_k[j] = hi_s[lay.C]
        # Slack boxes: s_row = b_row - min_v(A_row v) over the structural
        # box. The C column's term is kept out of smin_k and re-added on the
        # device from C_ub_k (the reference's drift-stable split).
        Arow = A_base[:m_ub, :N]
        smin = np.minimum(Arow * lo_s[None, :], Arow * hi_s[None, :]).sum(axis=1)
        aC = A_base[:m_ub, lay.C]
        cmin = np.minimum(aC * lo_s[lay.C], aC * hi_s[lay.C])
        smin_k[j] = smin - cmin
        hi_k[j, N:] = np.maximum(b_ub_scaled - smin, 0.0)

    int_mask = np.zeros(nf, dtype=bool)
    int_mask[:N] = arrays.integrality.astype(bool)

    gscale = None
    if lay.moe:
        gscale = np.stack([row_scale[4 * M : 5 * M], row_scale[5 * M : 6 * M]])

    return StandardForm(
        A=A,
        b_k=b_k,
        c_k=c_k,
        lo_k=lo_k,
        hi_k=hi_k,
        int_mask=int_mask,
        ks=[k for k, _ in kWs],
        Ws=[W for _, W in kWs],
        M=M,
        obj_const=arrays.obj_const,
        moe=lay.moe,
        A_base=A_base,
        smin_k=smin_k,
        C_ub_k=C_ub_k,
        gscale=gscale,
    )


def gky_scatter_table(g_raw, ks, gscale) -> Tuple[np.ndarray, np.ndarray]:
    """(gky, table) of the MoE expert-busy entries, float32: ``gky`` (n_k, M)
    = g_raw / k (the objective's y-column values) and ``table`` (n_k, 2, M)
    = the same values times the cycle and prefetch row scales, the per-k
    entries a node's A gets at rows 4M..6M, columns 2M..3M. Computed as the
    reference's device program does (division in float64, then products of
    float32 values), not as the float64 host form does."""
    gky = (
        np.asarray(g_raw, np.float64)[None, :] / np.asarray(ks, np.float64)[:, None]
    ).astype(np.float32)
    gs = np.asarray(gscale)
    table = np.stack(
        [gky * gs[0][None, :].astype(np.float32), gky * gs[1][None, :].astype(np.float32)],
        axis=1,
    )
    return gky, table
