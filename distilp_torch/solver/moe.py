"""MoE expert+layer co-assignment: the solver extension the reference
advertises but never built.

The reference profiles per-layer expert metrics (bytes_per_expert,
flops_per_expert, router_*, flops_per_active_expert_per_token —
upstream distilp src/distilp/profiler/profiler/model.py:1059-1073, schema
upstream distilp src/distilp/common/model.py:74-85) and its package
description promises "layer/expert assignment"
(upstream distilp pyproject.toml:4), yet ``solve_fixed_k_milp`` consumes only
the dense scalars. This module supplies the missing formulation.

Formulation (new design — there is no reference implementation):

- One integer variable ``y_i`` per device: how many of the ``E`` routed
  experts device i hosts. The split is the SAME for every MoE layer
  (standard expert-parallel sharding: device i owns expert slice
  [offset_i, offset_i + y_i) of each MoE layer), so ``sum_i y_i = E``.
- Expert weights are always resident — they are needed at every MoE layer,
  so unlike pipeline windows they cannot be disk-streamed. Device i's
  primary memory row gains ``eb_i * y_i`` bytes, where
  ``eb_i = (1+rho_w) * bytes_per_expert * n_moe``.
- Compute + dispatch: with uniform routing, device i executes the share
  ``y_i / E`` of every MoE layer's routed-expert FLOPs and receives the same
  share of the all-to-all token dispatch. Per pipeline segment (1/k of the
  layers, hence ``n_moe / k`` MoE layers on average) that adds

      g_i(k) * y_i,   g_i(k) = (n_moe / (k * E)) * (f_exp / s_i + 2 t_comm_i)

  seconds to the device's busy time B_i, where ``f_exp = experts_per_token *
  flops_per_active_expert_per_token`` is the active-expert work of one MoE
  layer and ``s_i`` the device's measured FLOPS. The ``1/k`` makes the busy
  rows k-dependent — the only place the MoE MILP family loses the shared-
  constraint-matrix property (handled by ``MilpArrays.A_ub_for_k``).
- The dense layer costs must not double-count experts: ``adjust_model``
  replaces the typical-layer scalars with the expert-free average layer
  (attention + router + shared experts for MoE layers, the dense scalar for
  dense layers), so ``w`` carries the pipeline-resident part and ``y``
  carries the expert part.

Certification note: the LP root integrality gap on wide-expert instances is
structural (box branch-and-bound alone stalls several percent short of the
optimum HiGHS reaches with cutting planes). The JAX backend closes it with
per-k Lagrangian decomposition root bounds — the coupling constraints
(sum w = W, sum y = E) are dualized and each device's subproblem is solved
exactly over its integer lattice on-device — which certify mip_gap<=1e-3 on
both flagships (Mixtral 8x7B and DeepSeek-V3 E=256 over 32 devices; see
``tests/test_solver_moe.py::test_deepseek_v3_flagship_certified`` and
``backend_jax._decomp_bound_roots``).

Expert pool placement (v2): each device hosts its expert slice in the
memory pool where expert compute is fastest, decided per device at
coefficient-build time:

- split-memory accelerator (CUDA/TPU) whose measured expert throughput
  beats the CPU's: expert bytes charge the VRAM capacity row
  (``eb_vram``) and expert compute uses the accelerator table;
- unified-memory accelerator (Apple Metal): compute at the faster of the
  two tables; bytes charge the unified budget either way (``eb_ram``), and
  when GPU compute wins they additionally charge the Metal working-set row
  (``eb_metal``) — the wired budget can be smaller than the unified one;
- otherwise: CPU table, primary-RAM residency (``eb_ram``).

This is a per-device *static* choice, not a per-expert solver variable: a
fractional ``y_gpu`` split of one device's experts across its two pools is
deliberately out of scope (expert slices are few and large, so the split
granularity buys almost nothing, while the extra integer block would grow
every backend — see git history for the trade study).

Expert residency is HARD-capped: expert weights are needed at every MoE
layer and cannot ride the disk-streaming slack the way pipeline-window
layers can, so the memory rows admit no slack on the ``eb*y`` term — a
fleet that cannot physically hold E experts is reported infeasible instead
of "optimal at a disk penalty" (physically unrealizable).

Dispatch pricing (v3): when the device profile carries the measured link
shape (``comm_latency``/``comm_bandwidth``, from the profiler's timed
collectives), the all-to-all hop is priced as
``2 x (latency + dispatched_bytes / bandwidth)`` — dispatch + combine,
with ``dispatched_bytes = experts_per_token * e_embed * 2`` (each decoded
token's bf16 hidden state shipped to its top-k experts). Profiles without
link terms (hand-written fleets, reference fixtures) fall back to the v2
``2 x t_comm`` scalar, so existing fixtures price identically.

Deliberate simplifications (documented, not hidden):
- The full a2a latency is charged per expert-unit share (inside the 1/E
  factor) rather than once per layer — same structural approximation the
  v2 scalar made; it keeps g linear in y.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..common import DeviceProfile, ModelProfile
from .coeffs import RHO_W, flops_over_flops_per_s


@dataclass
class MoEArrays:
    """Per-device MoE coefficients consumed by the assembler and backends."""

    E: int  # routed experts per MoE layer
    n_moe: int  # MoE layer count
    g_raw: np.ndarray  # (M,) seconds per y-unit per segment, times k
    eb_ram: np.ndarray  # (M,) resident bytes per y-unit in the primary pool
    eb_vram: np.ndarray  # (M,) resident bytes per y-unit in discrete VRAM
    # (M,) bytes per y-unit charged to the Metal working-set row: unified
    # devices whose expert compute elects the GPU table wire their expert
    # slice, so it must fit the (possibly smaller) wired budget too — the
    # unified budget row (eb_ram) alone would miss d_avail_metal < d_avail_ram.
    eb_metal: np.ndarray


def model_has_moe_components(model: ModelProfile) -> bool:
    """True when the profile carries enough MoE detail to co-assign experts."""
    return bool(
        model.is_moe
        and model.n_routed_experts > 0
        and model.total_moe_layers > 0
        and model.bytes_per_expert
        and model.flops_per_active_expert_per_token
    )


def resolve_moe(model: ModelProfile, moe) -> bool:
    """The ONE moe-mode resolution rule: ``None`` auto-detects from the
    profile's component metrics, ``True`` requires them, ``False`` forces
    dense. Shared by the solver instance builder and the twin so a
    placement is always evaluated under the same interpretation it was
    solved with."""
    use_moe = model_has_moe_components(model) if moe is None else bool(moe)
    if use_moe and not model_has_moe_components(model):
        raise ValueError(
            "moe=True requires a profile with MoE component metrics "
            "(bytes_per_expert, flops_per_active_expert_per_token, ...)"
        )
    return use_moe


def _moe_mean(d: Optional[dict], default: float = 0.0) -> float:
    if not d:
        return default
    vals = [float(v) for v in d.values()]
    return float(np.mean(vals)) if vals else default


def adjust_model(model: ModelProfile) -> ModelProfile:
    """Expert-free copy of the profile for the dense (w/n) part of the MILP.

    Typical-layer scalars become the average over ALL real layers of the
    expert-free cost: MoE layers contribute attention + router + shared
    experts; dense layers contribute the original typical scalars. KV/
    architecture fields are untouched (attention is identical either way).
    """
    if not model_has_moe_components(model):
        return model

    L = max(1, model.L)
    n_moe = model.total_moe_layers
    n_dense = max(0, L - n_moe)

    bpe = _moe_mean(model.bytes_per_expert)
    router_b = _moe_mean(model.router_bytes)
    shared_b = _moe_mean(model.bytes_shared_experts)

    # Average attention bytes over MoE layers. moe_layer_indices are 1-based
    # layer numbers; attn_bytes/attn_flops are 0-based length-L lists.
    moe_idx = model.moe_layer_indices or []
    if model.attn_bytes and moe_idx and len(model.attn_bytes) >= max(moe_idx):
        attn_b = float(np.mean([model.attn_bytes[i - 1] for i in moe_idx]))
    else:
        # No component split recorded: subtract the expert block instead.
        attn_b = max(0.0, float(model.b_layer) - model.n_routed_experts * bpe
                     - router_b - shared_b)

    b_moe_nonexp = attn_b + router_b + shared_b
    b_layer_adj = (n_dense * float(model.b_layer) + n_moe * b_moe_nonexp) / L

    # Expert-free FLOPs per batch key: attention + router + shared.
    f_exp_act = (
        model.experts_per_token
        * _moe_mean(model.flops_per_active_expert_per_token)
    )
    f_shared = _moe_mean(model.flops_shared_experts)
    f_router = _moe_mean(model.router_flops)

    f_q_adj = {}
    for bk, f_total in model.f_q.items():
        if (
            model.attn_flops
            and bk in model.attn_flops
            and moe_idx
            and len(model.attn_flops[bk]) >= max(moe_idx)
        ):
            attn_f = float(
                np.mean([model.attn_flops[bk][i - 1] for i in moe_idx])
            )
        else:
            attn_f = max(0.0, float(f_total) - f_exp_act - f_router - f_shared)
        f_moe_nonexp = attn_f + f_router + f_shared
        f_q_adj[bk] = (n_dense * float(f_total) + n_moe * f_moe_nonexp) / L

    return model.model_copy(
        update={"b_layer": int(round(b_layer_adj)), "f_q": f_q_adj}
    )


def build_moe_arrays(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    *,
    rho_w: float = RHO_W,
    load_factors: Optional[Sequence[float]] = None,
    factor_floor: float = 0.05,
) -> MoEArrays:
    """Derive the per-device expert coefficients from an (unadjusted) profile.

    ``load_factors`` (one multiplier per device, default all-1) scales each
    device's busy coefficient ``g_i`` by the realized per-y-unit load of a
    concrete expert->device mapping — the linearization handle of
    load-weighted routing (``solver.routing``). Residency bytes are NOT
    scaled: a hot expert occupies the same memory as a cold one.

    ``factor_floor`` guards the SOLVE pricing against oscillation (see the
    inline comment); evaluation callers that need the un-floored cost of a
    fixed placement (``routing.realized_objective``) pass 0.0.
    """
    if not model_has_moe_components(model):
        raise ValueError("model profile lacks the MoE component metrics")
    if load_factors is not None and len(load_factors) != len(devs):
        raise ValueError("load_factors must have one entry per device")

    M = len(devs)
    E = model.n_routed_experts
    n_moe = model.total_moe_layers
    bpe = _moe_mean(model.bytes_per_expert)
    f_exp = (
        model.experts_per_token
        * _moe_mean(model.flops_per_active_expert_per_token)
    )
    f_dict = {"b_1": f_exp}

    bytes_per_y = (1.0 + rho_w) * bpe * n_moe
    g_raw = np.zeros(M)
    eb_ram = np.full(M, bytes_per_y)
    eb_vram = np.zeros(M)
    eb_metal = np.zeros(M)
    for i, d in enumerate(devs):
        sec_cpu = flops_over_flops_per_s(f_dict, d.scpu, model.Q)
        sec_gpu = flops_over_flops_per_s(f_dict, d.gpu_table(), model.Q)
        has_split_accel = (d.has_tpu and d.d_avail_tpu is not None) or (
            d.has_cuda and d.d_avail_cuda is not None
        )
        # Pool choice (see module docstring). A 0.0 sec means "no table" —
        # never treat it as infinitely fast on either side.
        if d.is_unified_mem and sec_gpu > 0.0:
            use_gpu = sec_cpu == 0.0 or sec_gpu < sec_cpu
            sec = sec_gpu if use_gpu else sec_cpu
            if use_gpu:
                # GPU-resident experts are wired: they must also fit the
                # Metal working-set budget, not only the unified RAM row.
                eb_metal[i] = bytes_per_y
        elif has_split_accel and sec_gpu > 0.0 and (
            sec_gpu < sec_cpu or sec_cpu == 0.0
        ):
            sec = sec_gpu
            eb_ram[i], eb_vram[i] = 0.0, bytes_per_y
        else:
            sec = sec_cpu
        if d.comm_bandwidth > 0:
            # Payload-aware all-to-all: dispatch + combine of one token's
            # top-k expert traffic over the measured link (see module
            # docstring, "Dispatch pricing (v3)").
            a2a_bytes = model.experts_per_token * model.e_embed * 2.0
            a2a = 2.0 * (d.comm_latency + a2a_bytes / d.comm_bandwidth)
        else:
            a2a = 2.0 * d.t_comm
        # Floor the factor: a device whose mapped experts saw zero traffic
        # must not become FREE to host experts (g=0 would let the next tick
        # pile experts there up to memory and oscillate); the default 0.05
        # keeps a cold device cheap without making it a black hole.
        lf = (
            1.0 if load_factors is None
            else max(factor_floor, float(load_factors[i]))
        )
        g_raw[i] = lf * (n_moe / float(E)) * (sec + a2a)
    return MoEArrays(
        E=E, n_moe=n_moe, g_raw=g_raw, eb_ram=eb_ram, eb_vram=eb_vram,
        eb_metal=eb_metal,
    )
