"""Fixed-shape MILP assembly for the per-k HALDA subproblem.

Decision vector (N = 7M+1 dense, 8M+1 with MoE co-assignment), all integer
except z and C:

    x = [ w_0..w_{M-1} | n | (y) | s1 | s2 | s3 | t | z | C ]

    w_i  layers assigned to device i                 in [1, W]
    n_i  of those, layers resident on the accelerator in [0, W] (0 w/o GPU)
    y_i  routed experts hosted per MoE layer          in [0, E] (MoE mode)
    s1/s2/s3_i  RAM-overflow slack layers, gated to the device's set
    t_i  VRAM-overflow slack layers, gated on GPU presence
    z_i  pipeline stall seconds (continuous)
    C    steady-state cycle time seconds (continuous)

Constraint rows are emitted at a fixed count (6M inequality + 1 equality
dense; 8M + 2 with MoE) so every (M, k) instance of one fleet shares a
single array shape —
that is what lets the JAX backend vmap the k-sweep and batch branch-and-bound
nodes. Rows that don't apply to a device (no CUDA, no Metal) keep their
structural columns but get a huge RHS, and the variable bounds already pin
their variables to 0.

Row layout of A_ub:
    [0,  M)   n_i - w_i <= 0
    [M, 2M)   RAM/unified residency cap per device (set-dependent shape;
              MoE mode adds eb_ram_i * y_i resident expert bytes)
    [2M,3M)   CUDA VRAM cap (MoE mode adds eb_vram_i * y_i)
    [3M,4M)   Metal shared-memory cap (MoE mode adds eb_metal_i * y_i for
              unified devices whose expert compute elects the GPU table)
    [4M,5M)   cycle bound:   B_i + z_i - C <= -(xi_i + t_comm_i)
    [5M,6M)   prefetch bound: B_i + F_i - z_i - C <= -(xi_i + t_comm_i)
    [6M,7M)   (MoE only) s_i - w_i <= 0: a device cannot stream more layers
              than it hosts. Dense mode satisfies this automatically (the
              RAM violation is at most b'*w_i), but expert bytes would
              otherwise ride the layer slack; algebraically s_i <= w_i
              forces eb_ram*y to fit in physical capacity.
    [7M,8M)   (MoE only) t_i - n_i <= 0, same for the VRAM slack: forces
              eb_vram*y to fit in VRAM.

where B_i is the device busy time (a_i w_i + b_i n_i + disk penalties on the
slacks, plus the constant xi_i + t_comm_i — and, in MoE mode, the expert
share (g_raw_i / k) y_i) and F_i = (b'/s_disk_i) w_i the disk prefetch time
for the next window. Expert weights are always resident, so they appear in
the memory rows but never in F_i.

The MoE busy coefficient g_raw_i / k is the one k-DEPENDENT entry of the
constraint matrix (a segment covers n_moe/k MoE layers); ``A_ub_for_k``
materializes the per-k matrix. The dense mode keeps A fully k-independent.

Parity: the dense constraint set and objective match the reference MILP
(upstream distilp src/distilp/solver/halda_p_solver.py:59-366); the golden
fixture objectives pin the numerics. The MoE block is new design — see
``distilp_torch.solver.moe`` for the formulation rationale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .coeffs import HaldaCoeffs
from .moe import MoEArrays

# RHS standing in for "row inactive" — far beyond any byte count in a profile.
INACTIVE_RHS = 1e30


@dataclass(frozen=True)
class VarLayout:
    """Index helpers into the decision vector. ``moe`` inserts the y block
    after n and shifts everything behind it by M."""

    M: int
    moe: bool = False

    @property
    def ny(self) -> int:
        return self.M if self.moe else 0

    @property
    def n_vars(self) -> int:
        return 7 * self.M + self.ny + 1

    @property
    def n_eq(self) -> int:
        return 2 if self.moe else 1

    def w(self, i: int) -> int:
        return i

    def n(self, i: int) -> int:
        return self.M + i

    def y(self, i: int) -> int:
        if not self.moe:
            raise IndexError("y block only exists in MoE mode")
        return 2 * self.M + i

    def s1(self, i: int) -> int:
        return 2 * self.M + self.ny + i

    def s2(self, i: int) -> int:
        return 3 * self.M + self.ny + i

    def s3(self, i: int) -> int:
        return 4 * self.M + self.ny + i

    def t(self, i: int) -> int:
        return 5 * self.M + self.ny + i

    def z(self, i: int) -> int:
        return 6 * self.M + self.ny + i

    @property
    def z0(self) -> int:
        return 6 * self.M + self.ny

    @property
    def C(self) -> int:
        return 7 * self.M + self.ny


@dataclass
class MilpArrays:
    """The k-independent dense arrays of one HALDA instance.

    Only ``b_eq``'s W entry, the variable upper bounds, the objective's C
    coefficient, and (MoE mode) the y busy coefficients scale with k;
    everything else is shared across the whole k-sweep.
    """

    layout: VarLayout
    A_ub: np.ndarray  # (6M, N) — y busy coefficients left at 0 (k-dependent)
    b_ub: np.ndarray  # (6M,)
    A_eq: np.ndarray  # (n_eq, N)
    c_base: np.ndarray  # (N,) objective without the k-dependent coefficients
    integrality: np.ndarray  # (N,) 1 = integer, 0 = continuous
    # Per-variable bound templates: lb fixed; ub is ub_scale * W + ub_const,
    # with np.inf marking unbounded (z, C).
    lb: np.ndarray
    ub_scale: np.ndarray
    ub_const: np.ndarray
    obj_const: float  # additive constant: sum t_comm + sum xi + kappa
    moe: Optional[MoEArrays] = None

    def bounds_for_k(self, W: int) -> tuple[np.ndarray, np.ndarray]:
        ub = self.ub_scale * float(W) + self.ub_const
        return self.lb.copy(), ub

    def c_for_k(self, k: int) -> np.ndarray:
        c = self.c_base.copy()
        c[self.layout.C] = float(k - 1)
        if self.moe is not None:
            lay = self.layout
            for i in range(lay.M):
                c[lay.y(i)] = self.moe.g_raw[i] / float(k)
        return c

    def A_ub_for_k(self, k: int) -> np.ndarray:
        """The inequality matrix at one k (fills the y busy coefficients)."""
        if self.moe is None:
            return self.A_ub
        A = self.A_ub.copy()
        lay = self.layout
        M = lay.M
        for i in range(M):
            g_k = self.moe.g_raw[i] / float(k)
            A[4 * M + i, lay.y(i)] = g_k  # cycle row
            A[5 * M + i, lay.y(i)] = g_k  # prefetch row (contains B_i too)
        return A

    def b_eq_for_k(self, W: int) -> np.ndarray:
        if self.moe is None:
            return np.array([float(W)])
        return np.array([float(W), float(self.moe.E)])


def assemble(coeffs: HaldaCoeffs, moe: Optional[MoEArrays] = None) -> MilpArrays:
    """Emit the fixed-shape arrays for one (devices, model, kv_factor) instance."""
    M = coeffs.M
    lay = VarLayout(M, moe=moe is not None)
    N = lay.n_vars

    n_rows = 8 * M if moe is not None else 6 * M
    A_ub = np.zeros((n_rows, N))
    b_ub = np.zeros(n_rows)
    bp = coeffs.bprime

    # Per-device slack penalty coefficients reused by busy rows and objective.
    # The slack's disk penalty depends on which slack it is, not on the device
    # set, because bounds already pin out-of-set slacks to zero.
    pen = {
        "s1": coeffs.pen_m1,
        "s2": coeffs.pen_m2,
        "s3": coeffs.pen_m3,
        "t": coeffs.pen_vram,
    }

    for i in range(M):
        # --- accelerator-count row: n_i <= w_i ---
        r = i
        A_ub[r, lay.n(i)] = 1.0
        A_ub[r, lay.w(i)] = -1.0
        b_ub[r] = 0.0

        # --- RAM residency row ---
        r = M + i
        A_ub[r, lay.w(i)] = bp
        if coeffs.ram_minus_n[i]:
            A_ub[r, lay.n(i)] = -bp
        if moe is not None:
            A_ub[r, lay.y(i)] = moe.eb_ram[i]  # resident expert bytes
        sid = int(coeffs.set_id[i])
        slack_col = {1: lay.s1, 2: lay.s2, 3: lay.s3}[sid](i)
        A_ub[r, slack_col] = -bp
        b_ub[r] = coeffs.ram_rhs[i] if np.isfinite(coeffs.ram_rhs[i]) else INACTIVE_RHS

        # --- CUDA VRAM row (VRAM-resident experts charge it in MoE mode) ---
        r = 2 * M + i
        A_ub[r, lay.n(i)] = bp
        if moe is not None:
            A_ub[r, lay.y(i)] = moe.eb_vram[i]
        A_ub[r, lay.t(i)] = -bp
        b_ub[r] = coeffs.cuda_rhs[i] if coeffs.cuda_row[i] else INACTIVE_RHS

        # --- Metal shared-memory row (wired expert slices charge it too) ---
        r = 3 * M + i
        A_ub[r, lay.n(i)] = bp
        if moe is not None:
            A_ub[r, lay.y(i)] = moe.eb_metal[i]
        A_ub[r, lay.t(i)] = -bp
        b_ub[r] = coeffs.metal_rhs[i] if coeffs.metal_row[i] else INACTIVE_RHS

        # --- busy time B_i (shared by the two cycle rows; y filled per k) ---
        busy = np.zeros(N)
        busy[lay.w(i)] = coeffs.a[i]
        busy[lay.n(i)] = coeffs.b_gpu[i]
        busy[lay.s1(i)] = pen["s1"][i]
        busy[lay.s2(i)] = pen["s2"][i]
        busy[lay.s3(i)] = pen["s3"][i]
        busy[lay.t(i)] = pen["t"][i]
        busy_const = coeffs.busy_const[i]

        # --- cycle bound: B_i + const + z_i <= C ---
        r = 4 * M + i
        A_ub[r] = busy
        A_ub[r, lay.z(i)] += 1.0
        A_ub[r, lay.C] -= 1.0
        b_ub[r] = -busy_const

        # --- prefetch bound: z_i >= F_i - (C - B_i - const) ---
        r = 5 * M + i
        A_ub[r] = busy
        A_ub[r, lay.w(i)] += bp / coeffs.s_disk[i]
        A_ub[r, lay.z(i)] -= 1.0
        A_ub[r, lay.C] -= 1.0
        b_ub[r] = -busy_const

        # --- MoE hard caps: s_i <= w_i and t_i <= n_i (see row layout) ---
        if moe is not None:
            r = 6 * M + i
            A_ub[r, slack_col] = 1.0
            A_ub[r, lay.w(i)] = -1.0
            r = 7 * M + i
            A_ub[r, lay.t(i)] = 1.0
            A_ub[r, lay.n(i)] = -1.0

    # --- equalities: sum w_i = W; MoE mode adds sum y_i = E ---
    A_eq = np.zeros((lay.n_eq, N))
    A_eq[0, :M] = 1.0
    if moe is not None:
        A_eq[1, 2 * M : 3 * M] = 1.0

    # --- objective (k-dependent coefficients filled per k) ---
    c = np.zeros(N)
    c[:M] = coeffs.a
    c[M : 2 * M] = coeffs.b_gpu
    for name, sl in (("s1", lay.s1), ("s2", lay.s2), ("s3", lay.s3), ("t", lay.t)):
        for i in range(M):
            c[sl(i)] = pen[name][i]

    integrality = np.ones(N, dtype=np.int64)
    integrality[lay.z0 :] = 0  # z and C continuous

    # --- bounds templates ---
    lb = np.zeros(N)
    ub_scale = np.zeros(N)
    ub_const = np.zeros(N)

    lb[:M] = 1.0  # every device gets at least one layer
    ub_scale[:M] = 1.0  # w <= W
    ub_scale[M : 2 * M] = coeffs.has_gpu.astype(float)  # n <= W or 0
    if moe is not None:
        ub_const[2 * M : 3 * M] = float(moe.E)  # y <= E (k-independent)
    for sid, sl in ((1, lay.s1), (2, lay.s2), (3, lay.s3)):
        for i in range(M):
            in_set = int(coeffs.set_id[i]) == sid
            # Slack counts disk-streamed pipeline-window LAYERS, so its cap
            # is W in MoE mode too: expert weights are needed at every MoE
            # layer and cannot stream, so eb*y gets no slack — a fleet that
            # cannot hold E experts is infeasible, not "optimal at a disk
            # penalty" it could never realize.
            ub_scale[sl(i)] = 1.0 if in_set else 0.0
    for i in range(M):
        ub_scale[lay.t(i)] = 1.0 if coeffs.has_gpu[i] else 0.0
    ub_const[lay.z0 :] = np.inf  # z, C unbounded above

    return MilpArrays(
        layout=lay,
        A_ub=A_ub,
        b_ub=b_ub,
        A_eq=A_eq,
        c_base=c,
        integrality=integrality,
        lb=lb,
        ub_scale=ub_scale,
        ub_const=ub_const,
        obj_const=coeffs.obj_const,
        moe=moe,
    )
