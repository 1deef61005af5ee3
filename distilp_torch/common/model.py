"""Model profile schemas: analytic per-layer cost data as a JSON contract.

Three forms, wire-compatible with the reference
(upstream distilp src/distilp/common/model.py:12-251):

- ``ModelProfile``      — solver-facing scalars for a "typical" layer.
- ``ModelProfilePhased`` — {prefill, decode} pair of ``ModelProfile``.
- ``ModelProfileSplit``  — raw profiler output: per-layer arrays split by phase.

The Split→scalar conversion picks layer index 1 (the first real decoder layer;
index 0 is a synthetic placeholder) and the decode phase by default, exactly as
the reference loader does (common/model.py:193-251), because the golden solver
objectives are pinned to that choice.
"""

from __future__ import annotations

from typing import Dict, List, Literal, Optional

from pydantic import BaseModel, Field

from .types import ModelPhase, QuantizationLevel


class ModelProfile(BaseModel):
    """Solver input: architecture scalars + typical-layer cost scalars.

    Optionally carries the per-layer arrays and MoE component breakdowns the
    profiler produced, for detailed analysis and the MoE co-assignment solver.
    """

    # Architecture (paper symbols in comments)
    L: int = 0  # decoder layer count
    hk: int = 0  # KV heads (keys), h_k
    ek: int = 0  # head dim (keys), e_k
    hv: int = 0  # KV heads (values), h_v
    ev: int = 0  # head dim (values), e_v
    n_kv: int = 0  # KV-cache token capacity, n_kv
    e_embed: int = 0  # hidden size, e
    V: int = 0  # vocab size

    # Typical-layer scalars consumed by the solver
    b_layer: int = 0  # weight bytes per typical layer, b
    b_in: int = 0  # input-layer bytes, b_i
    b_out: int = 0  # output-layer bytes, b_o
    f_q: Dict[str, float] = Field(default_factory=dict)  # {"b_<B>": FLOPs} typical layer
    f_out: Dict[str, float] = Field(default_factory=dict)  # {"b_<B>": FLOPs} output layer
    Q: QuantizationLevel = "F16"  # quant level used for throughput lookup

    # Optional per-layer arrays (length L+1; index 0 is the synthetic layer)
    b_layers: Optional[List[int]] = None
    b_i_layers: Optional[List[int]] = None
    b_o_layers: Optional[List[int]] = None
    f_q_layers: Optional[Dict[str, List[float]]] = None

    # Profiler metadata
    seq_len: int = 0
    quantization: QuantizationLevel = "F16"

    # MoE configuration
    is_moe: bool = False
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_intermediate_size: int = 0
    moe_layer_freq: int = 1
    first_k_dense_replace: int = 0
    total_moe_layers: int = 0
    moe_layer_indices: Optional[List[int]] = None

    # MoE per-layer component metrics (keys are layer indices)
    attn_bytes: Optional[List[int]] = None
    attn_flops: Optional[Dict[str, List[float]]] = None
    bytes_per_expert: Optional[Dict[int, int]] = None
    bytes_shared_experts: Optional[Dict[int, int]] = None
    flops_per_expert: Optional[Dict[int, float]] = None
    flops_shared_experts: Optional[Dict[int, float]] = None
    router_flops: Optional[Dict[int, float]] = None
    router_bytes: Optional[Dict[int, int]] = None
    flops_per_active_expert_per_token: Optional[Dict[int, float]] = None

    # Measured expert popularity (extension; the natural carrier the
    # reference's per-expert metric dicts suggest but never fill,
    # upstream distilp src/distilp/common/model.py:79-85): entry e is the
    # relative token load routed to expert e, mean-1 normalized by the
    # solver. None = uniform routing. A streaming deployment refreshes this
    # from router statistics and re-solves; see ``solver.routing``.
    expert_loads: Optional[List[float]] = None

    def summary(self) -> str:
        mib = 1024.0**2
        lines = [
            "=" * 60,
            "Model Profile:",
            "=" * 60,
            f"  Layers (L): {self.L}",
        ]
        if self.b_layer > 0:
            lines.append(f"  Bytes per layer: {self.b_layer / mib:.1f} MB")
        if self.b_in > 0:
            lines.append(f"  Input bytes: {self.b_in / mib:.1f} MB")
        if self.b_out > 0:
            lines.append(f"  Output bytes: {self.b_out / mib:.1f} MB")
        lines += [
            f"  Attention heads (k/v): {self.hk}/{self.hv}",
            f"  Head dimensions (k/v): {self.ek}/{self.ev}",
            f"  KV cache tokens: {self.n_kv}",
            f"  Embedding dimension: {self.e_embed}",
            f"  Vocabulary size: {self.V}",
            f"  Quantization: {self.Q}",
        ]
        return "\n".join(lines)

    def print_summary(self) -> None:
        print(self.summary())


class ModelProfilePhased(BaseModel):
    """Prefill + decode profiles produced in one profiling run."""

    prefill: ModelProfile
    decode: ModelProfile

    def to_model_profile(
        self, phase: Literal["decode", "prefill"] = "decode"
    ) -> ModelProfile:
        if phase == "decode":
            return self.decode
        if phase == "prefill":
            return self.prefill
        raise ValueError(f"Invalid phase: {phase!r}. Must be 'decode' or 'prefill'.")


class ModelProfileSplit(BaseModel):
    """Raw profiler output: per-layer arrays, phase-split FLOPs, MoE components.

    Arrays have length L+1; index 0 is a synthetic placeholder row so that
    array index == decoder layer index for the real layers.
    """

    # Per-layer arrays
    b: List[int]  # weight bytes per layer
    b_i: List[int]  # input activation bytes per layer
    b_o: List[int]  # output activation bytes per layer

    # Architecture
    L: int
    hk: int
    hv: int
    ek: int
    ev: int
    n_kv: int
    e_embed: int
    V: int
    seq_len: int

    # {phase: {"b_<B>": [FLOPs per layer]}} and {phase: {"b_<B>": output FLOPs}}
    f_q: Dict[ModelPhase, Dict[str, List[float]]]
    f_out: Dict[ModelPhase, Dict[str, float]]
    quantization: QuantizationLevel

    # MoE
    is_moe: bool = False
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_intermediate_size: int = 0
    moe_layer_freq: int = 0
    first_k_dense_replace: int = 0
    total_moe_layers: int = 0
    moe_layer_indices: List[int] = Field(default_factory=list)

    # Component metrics for the expert co-assignment solver
    attn_bytes: List[int] = Field(default_factory=list)
    attn_flops: Dict[ModelPhase, Dict[str, List[float]]] = Field(default_factory=dict)
    bytes_per_expert: Dict[int, int] = Field(default_factory=dict)
    bytes_shared_experts: Dict[int, int] = Field(default_factory=dict)
    flops_per_expert: Dict[int, float] = Field(default_factory=dict)
    flops_shared_experts: Dict[int, float] = Field(default_factory=dict)
    router_flops: Dict[int, float] = Field(default_factory=dict)
    router_bytes: Dict[int, int] = Field(default_factory=dict)
    flops_per_active_expert_per_token: Dict[int, float] = Field(default_factory=dict)

    def to_model_profile(
        self, phase: Literal["decode", "prefill"] = "decode"
    ) -> ModelProfile:
        """Collapse per-layer arrays into the solver's typical-layer scalars.

        Layer index 1 is the representative layer; per-batch FLOPs come from
        the requested phase. Parity with the reference loader is required for
        the golden solver objectives (common/model.py:193-251).
        """
        typical = 1

        def pick(arr: List[int]) -> int:
            return arr[typical] if len(arr) > typical else 0

        f_q_scalars = {
            batch_key: values[typical]
            for batch_key, values in self.f_q[phase].items()
            if isinstance(values, list) and len(values) > typical
        }

        return ModelProfile(
            L=self.L,
            b_layer=pick(self.b),
            b_in=pick(self.b_i),
            b_out=pick(self.b_o),
            hk=self.hk,
            ek=self.ek,
            hv=self.hv,
            ev=self.ev,
            n_kv=self.n_kv,
            e_embed=self.e_embed,
            V=self.V,
            f_q=f_q_scalars,
            f_out=dict(self.f_out[phase]),
            Q=self.quantization,
            quantization=self.quantization,
            is_moe=self.is_moe,
            n_routed_experts=self.n_routed_experts,
            n_shared_experts=self.n_shared_experts,
            experts_per_token=self.experts_per_token,
            moe_intermediate_size=self.moe_intermediate_size,
            moe_layer_freq=self.moe_layer_freq,
            first_k_dense_replace=self.first_k_dense_replace,
            total_moe_layers=self.total_moe_layers,
            moe_layer_indices=self.moe_layer_indices,
            attn_bytes=self.attn_bytes,
            attn_flops=self.attn_flops.get(phase, {}),
            bytes_per_expert=self.bytes_per_expert,
            bytes_shared_experts=self.bytes_shared_experts,
            flops_per_expert=self.flops_per_expert,
            flops_shared_experts=self.flops_shared_experts,
            router_flops=self.router_flops,
            router_bytes=self.router_bytes,
            flops_per_active_expert_per_token=self.flops_per_active_expert_per_token,
        )
