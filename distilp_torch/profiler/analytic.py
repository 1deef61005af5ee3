"""Analytic model profiler: per-layer FLOPs/bytes from config metadata alone.

Numeric parity with the reference walker
(upstream distilp src/distilp/profiler/profiler/model.py:50-781) is pinned by
golden-value tests (reference test/test_models.py:54-121). The reference
instantiates an ``mlx_lm`` module tree and pattern-matches module names; this
implementation computes the same quantities directly from the
:class:`~distilp_torch.profiler.hfconfig.ArchSpec` layout registry — pure
arithmetic, no model framework, no network.

Conventions shared with the reference:
- FMA counts as 2 FLOPs; norms/RoPE count as 0.
- Activations are 16-bit; layer input/output bytes are ``B*L*H*2``.
- The per-layer arrays have length ``L+1``: index 0 is a synthetic all-zero
  "prefill" row so array index == decoder layer index
  (profiler/model.py:98-101).
- GQA/MHA projection sizes use ``head_size = hidden // heads`` even for
  families whose real ``head_dim`` differs (profiler/model.py:630) — the
  golden byte counts depend on this.
- Quantized tensors carry group metadata: 2 scale bytes per group, zero
  bytes for offsets (profiler/model.py:84-86).
- MoE router weights are recorded in ``router_bytes`` but NOT added to the
  layer's ``weight_bytes`` (profiler/model.py:176-192 mutates only
  ``moe_router_bytes``); replicated for fixture parity.
"""

from __future__ import annotations

from fnmatch import fnmatch
from math import ceil
from typing import Dict, List, NamedTuple, Optional, Sequence

from pydantic import BaseModel

from ..common import ModelProfile, ModelProfilePhased, ModelProfileSplit
from ..common.types import ModelPhase, QuantizationLevel
from .hfconfig import HFConfig

_SCALE_BYTES = 2
_ZERO_BYTES = 0
_A_BITS = 16  # activation width


class LayerCosts(BaseModel):
    """Per-layer profiling record (reference LayerMetadata,
    profiler/model.py:14-47, minus the module-tree bookkeeping fields)."""

    name: str = ""
    flops: float = 0.0
    weight_bytes: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    kv_cache_r: float = 0.0
    kv_cache_w: float = 0.0

    # Component breakdowns for the MoE co-assignment solver
    attn_flops: float = 0.0
    attn_bytes: int = 0
    moe_router_flops: float = 0.0
    moe_router_bytes: int = 0
    moe_expert_flops: float = 0.0
    moe_expert_bytes: int = 0
    moe_expert_flops_per_token: float = 0.0
    moe_shared_flops: float = 0.0
    moe_shared_bytes: int = 0
    is_moe_layer: bool = False


class QuantInfo(NamedTuple):
    bits: int
    group_size: int
    exclude_patterns: List[str]
    fp_bits: int
    label: QuantizationLevel


def parse_quantization_info(cfg: HFConfig) -> QuantInfo:
    """Read quantization metadata from the raw config
    (reference profiler/model.py:862-935)."""
    raw = cfg.raw
    bits = 0
    group_size = 0
    quant_method: Optional[str] = None
    exclude_patterns: List[str] = []

    if isinstance(raw.get("quantization"), dict):
        q = raw["quantization"]
        bits = int(q.get("bits", 0) or 0)
        group_size = int(q.get("group_size", 0) or 0)
    elif isinstance(raw.get("quantization_config"), dict):
        q = raw["quantization_config"]
        bits = int(q.get("bits", 0) or 0)
        group_size = int(q.get("group_size", 0) or 0)
        quant_method = q.get("quant_method")
        exclude_patterns = list(q.get("modules_to_not_convert", []) or [])

    dtype = raw.get("torch_dtype") or raw.get("dtype")
    if bits == 0:
        if quant_method in ("mxfp4", "MXFP4", "mx_fp4"):
            bits = 4
            if group_size == 0:
                group_size = 128
        if bits == 0 and dtype:
            if dtype in ("bfloat16", "bf16", "float16", "fp16"):
                bits = 16
            elif dtype in ("float32", "f32"):
                bits = 32
        if bits == 0:
            bits = 16

    fp_bits = 32 if dtype in ("float32", "f32") else 16

    label: QuantizationLevel
    mapping: Dict[int, QuantizationLevel] = {
        4: "Q4_K",
        5: "Q5_K",
        6: "Q6_K",
        8: "Q8_0",
        32: "F32",
    }
    if bits in mapping:
        label = mapping[bits]
    elif bits == 16:
        label = "BF16" if dtype in ("bfloat16", "bf16") else "F16"
    else:
        label = "F16"

    return QuantInfo(bits, group_size, exclude_patterns, fp_bits, label)


def _quantized_bytes(n: int, bits: int, group_size: int) -> int:
    """Packed code bytes + per-group scale/zero metadata
    (reference profiler/model.py:58-66)."""
    code_bytes = ceil(n * bits / 8)
    if group_size and group_size > 0:
        groups = (n + group_size - 1) // group_size
        meta_bytes = groups * (_SCALE_BYTES + _ZERO_BYTES)
    else:
        meta_bytes = 0
    return code_bytes + meta_bytes


def _tensor_bytes(n: int, bits: int, group_size: Optional[int]) -> int:
    if bits < 16 and group_size is not None:
        return _quantized_bytes(n, bits, group_size)
    return ceil(n * bits / 8)


def _is_excluded(path: str, patterns: Sequence[str]) -> bool:
    for pat in patterns:
        try:
            if fnmatch(path, pat):
                return True
        except Exception:
            pass
    return False


def _phase_tokens(phase: ModelPhase, B: int, L: int) -> int:
    """Tokens pushed through the weights per phase
    (reference profiler/model.py:121-129)."""
    if phase == "prefill":
        return B * L
    if phase == "decode":
        return B
    return B * L + B  # merged: full prefill + one decode step


def _phase_pick(phase: ModelPhase, prefill_val: float, decode_val: float) -> float:
    if phase == "prefill":
        return prefill_val
    if phase == "decode":
        return decode_val
    return prefill_val + decode_val


def _attention_costs(
    cfg: HFConfig,
    lm: LayerCosts,
    idx: int,
    tokens: int,
    B: int,
    L: int,
    phase: ModelPhase,
    q: QuantInfo,
) -> None:
    """Attention projections + attention core + KV-cache traffic.

    Branch selection and formulas match the reference walker: MLA
    (profiler/model.py:506-622), GQA (:629-724), MHA (:727-777).
    """
    H = cfg.hidden_size()
    A = cfg.num_attention_heads()
    kv_heads = cfg.num_key_value_heads()
    is_gqa = kv_heads != A

    attn_path = f"model.layers.{idx}.self_attn"
    w_bits = q.fp_bits if _is_excluded(attn_path, q.exclude_patterns) else q.bits

    if cfg.is_mla():
        if not any(cfg.raw.get(k) is not None for k in ("kv_lora_rank", "v_head_dim")):
            # Low-rank replace without latent KV: unimplemented in the
            # reference too (profiler/model.py:624-627).
            return
        if is_gqa:
            raise NotImplementedError(
                "MLA with grouped KV heads is not modeled (the reference "
                "walker crashes on this path, profiler/model.py:517-518)"
            )
        q_head_dim = cfg.qk_nope_head_dim() + cfg.qk_rope_head_dim()
        q_lora = cfg.q_lora_rank()
        kv_lora = cfg.kv_lora_rank()
        v_head = cfg.v_head_dim()

        q_a_f = 2 * tokens * H * q_lora
        q_b_f = 2 * tokens * A * q_head_dim * q_lora
        kv_a_f = 2 * tokens * (kv_lora + cfg.qk_rope_head_dim()) * H
        kv_b_f = 2 * tokens * kv_lora * A * (cfg.qk_nope_head_dim() + v_head)
        o_f = 2 * tokens * A * v_head * H

        out_features = kv_lora + cfg.qk_rope_head_dim()
        param_counts = (
            q_lora * H,  # q_a
            A * q_head_dim * q_lora,  # q_b
            out_features * H,  # kv_a_with_mqa
            out_features * kv_lora,  # kv_b (reference sizing, model.py:535)
            H * A * v_head,  # o
        )

        kv_elems = kv_lora + cfg.qk_rope_head_dim()
        lm.kv_cache_w = (
            B * L * kv_elems * _A_BITS / 8
            if phase == "prefill"
            else B * 1 * kv_elems * _A_BITS / 8
            if phase == "decode"
            else B * (L + 1) * kv_elems * _A_BITS / 8
        )
        lm.kv_cache_r = 0.0 if phase == "prefill" else B * L * kv_elems * _A_BITS / 8

        attn_core = _phase_pick(
            phase,
            4 * B * A * (L * L) * q_head_dim,
            4 * B * A * L * q_head_dim,
        )
        attn_flops = q_a_f + q_b_f + kv_a_f + kv_b_f + o_f + attn_core
        attn_bytes = sum(
            _tensor_bytes(n, w_bits, q.group_size or None) for n in param_counts
        )
    else:
        head_size = H // A  # NOT cfg.head_dim(): golden parity, model.py:630
        if is_gqa:
            kv_out = kv_heads * head_size
            param_counts = (H * H, H * kv_out, H * kv_out, H * H)
            proj_flops = sum(2 * tokens * n for n in param_counts)
            attn_bytes = sum(
                _tensor_bytes(n, w_bits, q.group_size or None) for n in param_counts
            )
            kv_elems = 2 * kv_heads * head_size
        else:
            proj_flops = 4 * (2 * tokens * H * H)
            # MHA quantizes Q,K,V,O as one 4*H^2 blob (model.py:759-766).
            attn_bytes = _tensor_bytes(4 * H * H, w_bits, q.group_size or None)
            kv_elems = 2 * H

        attn_core = _phase_pick(
            phase,
            4 * B * A * (L * L) * head_size,
            4 * B * A * L * head_size,
        )
        attn_flops = proj_flops + attn_core
        lm.kv_cache_w = float(
            (B * L * kv_elems * _A_BITS) // 8
            if phase == "prefill"
            else (B * 1 * kv_elems * _A_BITS) // 8
            if phase == "decode"
            else (B * (L + 1) * kv_elems * _A_BITS) // 8
        )
        lm.kv_cache_r = (
            0.0 if phase == "prefill" else float((B * L * kv_elems * _A_BITS) // 8)
        )

    lm.flops += attn_flops
    lm.attn_flops = attn_flops
    lm.weight_bytes += attn_bytes
    lm.attn_bytes = attn_bytes


def _dense_mlp_costs(
    cfg: HFConfig, lm: LayerCosts, idx: int, tokens: int, q: QuantInfo
) -> None:
    """Dense GLU MLP: 3 effective projections whether the family stores them
    separately or fused (reference profiler/model.py:461-492)."""
    H = cfg.hidden_size()
    inter = cfg.intermediate_size()
    w_bits = q.bits  # dense MLP path applies no exclusion (model.py:472)
    for proj in cfg.spec.mlp_projections:
        width = 2 * inter if proj == "gate_up_proj" else inter
        lm.flops += 2 * tokens * H * width
        lm.weight_bytes += _tensor_bytes(H * width, w_bits, q.group_size or None)


def _moe_costs(
    cfg: HFConfig, lm: LayerCosts, idx: int, tokens: int, q: QuantInfo
) -> None:
    """Sparse-MoE block: router + routed experts + optional shared experts
    (reference profiler/model.py:144-459)."""
    H = cfg.hidden_size()
    E = cfg.n_routed_experts()
    topk = cfg.num_experts_tok()
    moe_inter = cfg.moe_intermediate()
    if moe_inter == 0:
        raise ValueError(
            "MoE layer detected but no valid intermediate size found in config"
        )
    lm.is_moe_layer = True
    mlp_path = f"model.layers.{idx}.mlp"
    router_path = f"model.layers.{idx}.mlp.router"

    # Router / gate
    gate_f = 2 * tokens * H * E
    lm.flops += gate_f
    lm.moe_router_flops = gate_f
    router_bits = q.fp_bits if _is_excluded(router_path, q.exclude_patterns) else q.bits
    lm.moe_router_bytes = _tensor_bytes(H * E, router_bits, q.group_size or None)

    # Routed experts. Layers the config marks as dense-replaced still get
    # expert costs in the reference (its tier-3 fallback fires because the
    # config says E>0, profiler/model.py:386-424) — with an activation term
    # and without shared experts.
    dense_replaced = idx <= cfg.first_k_dense_replace()
    layout = cfg.spec.moe.routed_layout if cfg.spec.moe else "switch_glu"
    with_activation = layout == "fused_gate_up" or dense_replaced

    num_proj = 3
    DS = H * moe_inter
    smlp_f = num_proj * (2 * tokens * topk * DS)
    if with_activation:
        smlp_f += tokens * topk * moe_inter

    w_bits = q.fp_bits if _is_excluded(mlp_path, q.exclude_patterns) else q.bits
    if w_bits < 16 and (q.group_size or None) is not None:
        smlp_b = E * num_proj * _quantized_bytes(H * moe_inter, w_bits, q.group_size)
    else:
        smlp_b = ceil(E * num_proj * H * moe_inter * w_bits / 8)
    lm.weight_bytes += smlp_b
    lm.flops += smlp_f
    lm.moe_expert_flops = smlp_f / E if E > 0 else 0.0
    lm.moe_expert_bytes = smlp_b // E if E > 0 else 0
    lm.moe_expert_flops_per_token = 2 * num_proj * H * moe_inter + moe_inter

    # Shared experts (deepseek-style)
    n_shared = cfg.n_shared()
    if n_shared > 0 and not dense_replaced:
        shared_inter = cfg.shared_intermediate()
        se_f = num_proj * (2 * tokens * H * n_shared * shared_inter)
        if w_bits < 16 and (q.group_size or None) is not None:
            se_b = n_shared * num_proj * _quantized_bytes(
                H * shared_inter, w_bits, q.group_size
            )
        else:
            se_b = (n_shared * num_proj * H * shared_inter * w_bits) // 8
        lm.weight_bytes += se_b
        lm.flops += se_f
        lm.moe_shared_flops = se_f
        lm.moe_shared_bytes = se_b


def profile_layers(
    cfg: HFConfig,
    B: int = 1,
    L: int = 4096,
    phase: ModelPhase = "merged",
    quant: Optional[QuantInfo] = None,
) -> List[LayerCosts]:
    """Per-layer cost records, length ``num_hidden_layers + 1``
    (index 0 is the synthetic zero row)."""
    q = quant or parse_quantization_info(cfg)
    H = cfg.hidden_size()
    tokens = _phase_tokens(phase, B, L)
    io_bytes = ceil(B * L * H * _A_BITS / 8)

    has_moe = cfg.spec.moe is not None and cfg.n_routed_experts() != 0
    layer_freq = cfg.moe_layer_freq()
    mlp_only = set(cfg.mlp_only_layers())

    layers: List[LayerCosts] = [LayerCosts(name="prefill")]
    for idx in range(1, cfg.num_hidden_layers() + 1):
        lm = LayerCosts(name=f"decoder_{idx}")
        lm.input_bytes = io_bytes
        lm.output_bytes = io_bytes
        _attention_costs(cfg, lm, idx, tokens, B, L, phase, q)
        if has_moe and idx % layer_freq == 0 and idx not in mlp_only:
            _moe_costs(cfg, lm, idx, tokens, q)
        else:
            _dense_mlp_costs(cfg, lm, idx, tokens, q)
        layers.append(lm)
    return layers


def _fill_common(
    ret: ModelProfile, cfg: HFConfig, layers: List[LayerCosts], B: int, L: int
) -> None:
    ret.b_layers = [int(x.weight_bytes) for x in layers]
    ret.b_i_layers = [int(x.input_bytes) for x in layers]
    ret.b_o_layers = [int(x.output_bytes) for x in layers]
    if ret.f_q_layers is None:
        ret.f_q_layers = {}
    tag = f"b_{B}"
    ret.f_q_layers[tag] = [float(x.flops) for x in layers]
    ret.f_out[tag] = ret.f_q_layers[tag][-1] if ret.f_q_layers[tag] else 0.0
    ret.seq_len = int(L)

    ret.L = cfg.num_hidden_layers()
    ret.e_embed = cfg.hidden_size()
    ret.V = cfg.vocab_size()
    ret.hk = cfg.num_key_value_heads()
    ret.hv = cfg.num_key_value_heads()
    head_dim = cfg.head_dim()
    if head_dim == 0 and ret.e_embed > 0 and cfg.num_attention_heads() > 0:
        head_dim = ret.e_embed // cfg.num_attention_heads()
    ret.ek = head_dim
    ret.ev = head_dim
    ret.n_kv = cfg.max_position_embeddings(L)


def profile_model(
    cfg: HFConfig,
    B: int = 1,
    L: int = 4096,
    bs_list: Optional[List[int]] = None,
    phase: ModelPhase = "merged",
) -> ModelProfile:
    """Dense-model profile (reference profiler/model.py:785-858)."""
    q = parse_quantization_info(cfg)
    layers = profile_layers(cfg, B, L, phase, q)
    ret = ModelProfile()
    _fill_common(ret, cfg, layers, B, L)
    ret.quantization = q.label
    ret.Q = q.label

    for Bx in bs_list or []:
        tag = f"b_{Bx}"
        layers_bx = profile_layers(cfg, Bx, L, phase, q)
        ret.f_q_layers[tag] = [float(x.flops) for x in layers_bx]
        ret.f_out[tag] = ret.f_q_layers[tag][-1] if ret.f_q_layers[tag] else 0.0
    return ret


def profile_moe_model(
    cfg: HFConfig,
    B: int = 1,
    L: int = 4096,
    bs_list: Optional[List[int]] = None,
    phase: ModelPhase = "merged",
) -> ModelProfile:
    """MoE-aware profile with component metrics for expert co-assignment
    (reference profiler/model.py:938-1098). Delegates to
    :func:`profile_model` for dense models."""
    if cfg.spec.moe is None or cfg.n_routed_experts() == 0:
        return profile_model(cfg, B, L, bs_list, phase)

    q = parse_quantization_info(cfg)
    layers = profile_layers(cfg, B, L, phase, q)
    ret = ModelProfile()
    ret.is_moe = True
    _fill_common(ret, cfg, layers, B, L)
    ret.quantization = q.label
    ret.Q = q.label

    ret.n_routed_experts = cfg.n_routed_experts()
    ret.n_shared_experts = (
        cfg.n_shared() if cfg.n_shared() > 0 else (1 if cfg.shared_intermediate() > 0 else 0)
    )
    ret.experts_per_token = cfg.num_experts_tok()
    ret.moe_intermediate_size = cfg.moe_intermediate()
    if ret.moe_intermediate_size == 0:
        raise ValueError(
            "MoE model detected but no valid intermediate/FFN size found"
        )
    ret.moe_layer_freq = cfg.moe_layer_freq()
    # The reference hard-codes 0 here regardless of config
    # (profiler/model.py:1029-1031); we report the config value, which the
    # co-assignment solver needs.
    ret.first_k_dense_replace = cfg.first_k_dense_replace()

    moe_indices = [i for i, lyr in enumerate(layers[1:], 1) if lyr.is_moe_layer]
    ret.moe_layer_indices = moe_indices
    ret.total_moe_layers = len(moe_indices)

    ret.attn_bytes = []
    ret.attn_flops = {f"b_{B}": []}
    ret.bytes_per_expert = {}
    ret.bytes_shared_experts = {}
    ret.flops_per_expert = {}
    ret.flops_shared_experts = {}
    ret.router_flops = {}
    ret.router_bytes = {}
    ret.flops_per_active_expert_per_token = {}

    for idx, lyr in enumerate(layers[1:], 1):
        ret.attn_bytes.append(lyr.attn_bytes)
        ret.attn_flops[f"b_{B}"].append(lyr.attn_flops)
        if lyr.is_moe_layer:
            ret.bytes_per_expert[idx] = lyr.moe_expert_bytes
            ret.bytes_shared_experts[idx] = lyr.moe_shared_bytes
            ret.flops_per_expert[idx] = lyr.moe_expert_flops
            ret.flops_shared_experts[idx] = lyr.moe_shared_flops
            ret.router_flops[idx] = lyr.moe_router_flops
            ret.router_bytes[idx] = lyr.moe_router_bytes
            ret.flops_per_active_expert_per_token[idx] = lyr.moe_expert_flops_per_token

    for Bx in bs_list or []:
        tag = f"b_{Bx}"
        layers_bx = profile_layers(cfg, Bx, L, phase, q)
        ret.f_q_layers[tag] = [float(x.flops) for x in layers_bx]
        ret.f_out[tag] = ret.f_q_layers[tag][-1] if ret.f_q_layers[tag] else 0.0
        ret.attn_flops[tag] = [float(x.attn_flops) for x in layers_bx[1:]]
    return ret


def profile_model_phased(
    cfg: HFConfig,
    B: int,
    L: int,
    bs_list: Optional[List[int]] = None,
) -> ModelProfilePhased:
    """Prefill + decode profiles in one run (reference profiler/model.py:1101-1125)."""
    return ModelProfilePhased(
        prefill=profile_moe_model(cfg, B, L, bs_list, "prefill"),
        decode=profile_moe_model(cfg, B, L, bs_list, "decode"),
    )


def profile_model_split(
    cfg: HFConfig,
    B: int,
    L: int,
    bs_list: Optional[List[int]] = None,
) -> ModelProfileSplit:
    """Merge phased profiles into the wire format
    (reference profiler/model.py:1128-1193)."""
    phased = profile_model_phased(cfg, B, L, bs_list)
    pre, dec = phased.prefill, phased.decode

    result = ModelProfileSplit(
        b=pre.b_layers or [],
        b_i=pre.b_i_layers or [],
        b_o=pre.b_o_layers or [],
        L=pre.L,
        hk=pre.hk,
        hv=pre.hv,
        ek=pre.ek,
        ev=pre.ev,
        n_kv=pre.n_kv,
        e_embed=pre.e_embed,
        V=pre.V,
        seq_len=pre.seq_len,
        f_q={
            "prefill": pre.f_q_layers or {},
            "decode": dec.f_q_layers or {},
        },
        f_out={
            "prefill": pre.f_out,
            "decode": dec.f_out,
        },
        quantization=pre.quantization,
    )

    if pre.is_moe:
        result.is_moe = True
        result.n_routed_experts = pre.n_routed_experts
        result.n_shared_experts = pre.n_shared_experts
        result.experts_per_token = pre.experts_per_token
        result.moe_intermediate_size = pre.moe_intermediate_size
        result.moe_layer_freq = pre.moe_layer_freq
        result.first_k_dense_replace = pre.first_k_dense_replace
        result.total_moe_layers = pre.total_moe_layers
        result.moe_layer_indices = pre.moe_layer_indices or []
        result.attn_bytes = pre.attn_bytes or []
        result.attn_flops = {
            "prefill": pre.attn_flops or {},
            "decode": (dec.attn_flops or {}) if dec.is_moe else {},
        }
        result.bytes_per_expert = pre.bytes_per_expert or {}
        result.bytes_shared_experts = pre.bytes_shared_experts or {}
        result.flops_per_expert = pre.flops_per_expert or {}
        result.flops_shared_experts = pre.flops_shared_experts or {}
        result.router_flops = pre.router_flops or {}
        result.router_bytes = pre.router_bytes or {}
        result.flops_per_active_expert_per_token = (
            pre.flops_per_active_expert_per_token or {}
        )

    return result
