"""HF ``config.json`` adapter: architecture registry + normalized accessors.

Replaces the reference's mlx_lm-backed adapter
(upstream distilp src/distilp/profiler/models.py) with a pure-metadata design:
instead of validating the config through per-arch ``mlx_lm ModelArgs`` classes
and later instantiating a module tree to walk, each supported architecture is
described by a small :class:`ArchSpec` record stating how its decoder blocks
are laid out (attention kind, MLP projection set, MoE structure). The analytic
profiler consumes the spec directly, so no model framework and no macOS/Metal
dependency is needed.

Accessor semantics match the reference adapter exactly (models.py:182-364):
e.g. ``head_dim()`` returns ``hidden_size // num_attention_heads`` for the
llama/phi3/mistral/qwen2/qwen2_moe/deepseek_v3/olmo3 families and the config's
explicit ``head_dim`` otherwise (models.py:210-222), and
``max_position_embeddings(default)`` falls back to the profiling sequence
length for families whose ModelArgs lacks the field (models.py:194-207).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Literal, Optional, Sequence, Union

AttentionKind = Literal["standard", "mla"]  # standard = MHA/GQA chosen by head counts
MoERoutedLayout = Literal["switch_glu", "fused_gate_up"]


@dataclass(frozen=True)
class MoESpec:
    """How an architecture's sparse-MoE blocks are shaped.

    ``routed_layout`` mirrors what the reference's module-tree walk would have
    found: ``switch_glu`` = separate gate/up/down expert projections (3 GEMMs,
    no explicit activation FLOPs term — reference profiler/model.py:195-256);
    ``fused_gate_up`` = fused gate_up + down projections discovered via the
    fallback pattern detector, which adds an activation term
    (profiler/model.py:319-355, the gpt-oss shape).
    """

    experts_key: str  # config key holding the routed-expert count
    topk_key: str = "num_experts_per_tok"
    routed_layout: MoERoutedLayout = "switch_glu"
    moe_intermediate_key: Optional[str] = "moe_intermediate_size"
    shared_experts_key: Optional[str] = None  # deepseek: "n_shared_experts"
    # Families whose shared expert is structural rather than configured:
    # qwen2_moe always has exactly one (the HF config publishes only its
    # size, shared_expert_intermediate_size, never a count).
    implicit_shared: int = 0
    layer_freq_key: Optional[str] = None  # qwen3_moe: decoder_sparse_step
    mlp_only_layers_key: Optional[str] = None
    first_k_dense_key: Optional[str] = None


@dataclass(frozen=True)
class ArchSpec:
    """Decoder-block layout facts for one model family."""

    name: str
    head_dim_from_config: bool  # False => hidden_size // num_attention_heads
    has_max_position_embeddings: bool
    attention: AttentionKind = "standard"
    # Dense-MLP projection names; totals match the reference walker whether
    # the family uses 3 separate GLU projections or a fused gate_up
    # (profiler/model.py:461-492).
    mlp_projections: Sequence[str] = ("gate_proj", "up_proj", "down_proj")
    moe: Optional[MoESpec] = None


_GLU3 = ("gate_proj", "up_proj", "down_proj")
_FUSED = ("gate_up_proj", "down_proj")

ARCHS: Dict[str, ArchSpec] = {
    "llama": ArchSpec("llama", False, False),
    # "mistral" is the Mixtral family in the reference registry
    # (models.py:9,93-95): MoE with routed experts sized by intermediate_size.
    # Divergence from reference (documented): the reference walker never
    # descends into Mixtral's `block_sparse_moe` module (its name is not in
    # the MLP-name list, profiler/model.py:136), silently producing
    # attention-only profiles; we profile the experts properly.
    "mistral": ArchSpec(
        "mistral",
        False,
        False,
        moe=MoESpec(experts_key="num_local_experts", moe_intermediate_key=None),
    ),
    "qwen2": ArchSpec("qwen2", False, True),
    "qwen2_moe": ArchSpec(
        "qwen2_moe",
        False,
        False,
        moe=MoESpec(experts_key="num_experts", implicit_shared=1),
    ),
    "qwen3": ArchSpec("qwen3", True, True),
    "qwen3_moe": ArchSpec(
        "qwen3_moe",
        True,
        True,
        moe=MoESpec(
            experts_key="num_experts",
            layer_freq_key="decoder_sparse_step",
            mlp_only_layers_key="mlp_only_layers",
        ),
    ),
    "gemma2": ArchSpec("gemma2", True, False),
    "phi3": ArchSpec("phi3", False, True, mlp_projections=_FUSED),
    "gpt_oss": ArchSpec(
        "gpt_oss",
        True,
        False,
        moe=MoESpec(
            experts_key="num_local_experts",
            routed_layout="fused_gate_up",
            moe_intermediate_key=None,
        ),
    ),
    "deepseek_v3": ArchSpec(
        "deepseek_v3",
        False,
        True,
        attention="mla",
        moe=MoESpec(
            experts_key="n_routed_experts",
            shared_experts_key="n_shared_experts",
            layer_freq_key="moe_layer_freq",
            first_k_dense_key="first_k_dense_replace",
        ),
    ),
    "olmo3": ArchSpec("olmo3", False, True),
    "glm4": ArchSpec("glm4", True, True, mlp_projections=_FUSED),
}

# HF model_type -> arch name (reference models.py:41-75).
MODEL_TYPE_ALIASES: Dict[str, str] = {
    "llama": "llama",
    "llama2": "llama",
    "llama-2": "llama",
    "llama3": "llama",
    "llama-3": "llama",
    "mistral": "mistral",
    "mixtral": "mistral",
    "qwen2": "qwen2",
    "qwen-2": "qwen2",
    "qwen2_moe": "qwen2_moe",
    "qwen2-moe": "qwen2_moe",
    "qwen3": "qwen3",
    "qwen-3": "qwen3",
    "qwen3_moe": "qwen3_moe",
    "qwen3-moe": "qwen3_moe",
    "gemma": "gemma2",
    "gemma2": "gemma2",
    "phi3": "phi3",
    "gpt_oss": "gpt_oss",
    "deepseek_v3": "deepseek_v3",
    "deepseek-v3": "deepseek_v3",
    "olmo3": "olmo3",
    "olmo-3": "olmo3",
    "glm4": "glm4",
    "glm-4": "glm4",
}


class HFConfig:
    """A parsed HF config with arch-normalized accessors.

    ``raw`` is the verbatim ``config.json`` dict (the reference keeps the same
    attribute for quantization parsing and MLA field probing,
    models.py:151-152).
    """

    def __init__(self, raw: Dict[str, Any], arch: Optional[str] = None):
        self.raw = dict(raw)
        name = arch or resolve_arch(raw)
        if name not in ARCHS:
            raise ValueError(f"Unsupported architecture {name!r}")
        self.spec: ArchSpec = ARCHS[name]

    # -- helpers ----------------------------------------------------------
    def _get(self, key: str, default: Any = None) -> Any:
        value = self.raw.get(key)
        return default if value is None else value

    def _require(self, key: str) -> Any:
        if self.raw.get(key) is None:
            raise KeyError(
                f"config.json for {self.spec.name!r} is missing required key {key!r}"
            )
        return self.raw[key]

    # -- core accessors (reference models.py:182-235) ---------------------
    def model_type(self) -> str:
        return str(self._get("model_type", self.spec.name))

    def hidden_size(self) -> int:
        return int(self._require("hidden_size"))

    def num_hidden_layers(self) -> int:
        return int(self._require("num_hidden_layers"))

    def intermediate_size(self) -> int:
        return int(self._require("intermediate_size"))

    def num_attention_heads(self) -> int:
        return int(self._require("num_attention_heads"))

    def num_key_value_heads(self) -> int:
        # Fall back to num_attention_heads (reference models.py:224-229).
        value = self.raw.get("num_key_value_heads")
        return int(value) if value is not None else self.num_attention_heads()

    def vocab_size(self) -> int:
        return int(self._require("vocab_size"))

    def head_dim(self) -> int:
        if self.spec.head_dim_from_config:
            return int(self._require("head_dim"))
        return self.hidden_size() // self.num_attention_heads()

    def max_position_embeddings(self, default: int) -> int:
        if self.spec.has_max_position_embeddings:
            return int(self._get("max_position_embeddings", default))
        return int(default)

    # -- MoE accessors (reference models.py:237-300) -----------------------
    def n_routed_experts(self) -> int:
        if self.spec.moe is None:
            return 0
        return int(self._get(self.spec.moe.experts_key, 0))

    def num_experts_tok(self) -> int:
        if self.spec.moe is None:
            raise ValueError(
                f"num_experts_tok is not applicable for {self.spec.name}"
            )
        return int(self._get(self.spec.moe.topk_key, 0))

    def moe_layer_freq(self) -> int:
        moe = self.spec.moe
        if moe is not None and moe.layer_freq_key is not None:
            return int(self._get(moe.layer_freq_key, 1))
        return 1

    def mlp_only_layers(self) -> list:
        moe = self.spec.moe
        if moe is not None and moe.mlp_only_layers_key is not None:
            return list(self._get(moe.mlp_only_layers_key, []))
        return []

    def moe_intermediate(self) -> int:
        moe = self.spec.moe
        if moe is not None and moe.moe_intermediate_key is not None:
            return int(self._get(moe.moe_intermediate_key, 0))
        # Families without a dedicated MoE size use the dense FFN size
        # (reference models.py:263-273).
        return self.intermediate_size()

    def shared_intermediate(self) -> int:
        # qwen2_moe publishes shared_expert_intermediate_size
        # (reference models.py:275-280); everyone else reuses the MoE size.
        if self.spec.name == "qwen2_moe":
            return int(self._get("shared_expert_intermediate_size", 0))
        return self.moe_intermediate()

    def n_shared(self) -> int:
        moe = self.spec.moe
        if moe is not None and moe.shared_experts_key is not None:
            return int(self._get(moe.shared_experts_key, 0))
        return moe.implicit_shared if moe is not None else 0

    def first_k_dense_replace(self) -> int:
        moe = self.spec.moe
        if moe is not None and moe.first_k_dense_key is not None:
            return int(self._get(moe.first_k_dense_key, 0))
        return 0

    # -- MLA accessors (reference models.py:306-324) -----------------------
    def is_mla(self) -> bool:
        # Same probe as the reference walker (profiler/model.py:503):
        # presence of the low-rank attention fields in the raw config.
        return all(
            self.raw.get(k) is not None
            for k in ("q_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim")
        )

    def q_lora_rank(self) -> int:
        return int(self._get("q_lora_rank", 0))

    def kv_lora_rank(self) -> int:
        return int(self._get("kv_lora_rank", 0))

    def qk_rope_head_dim(self) -> int:
        return int(self._get("qk_rope_head_dim", 0))

    def qk_nope_head_dim(self) -> int:
        return int(self._get("qk_nope_head_dim", 0))

    def v_head_dim(self) -> int:
        return int(self._get("v_head_dim", 0))


def resolve_arch(config: Dict[str, Any]) -> str:
    """Map ``config.model_type`` to an arch name (reference models.py:402-422)."""
    model_type = config.get("model_type")
    if not model_type:
        raise ValueError("config.json is missing 'model_type'")
    key = str(model_type).strip().replace(" ", "").lower()
    arch = MODEL_TYPE_ALIASES.get(key)
    if arch is None:
        raise ValueError(f"Unsupported or unknown model_type {model_type!r}")
    return arch


ConfigSource = Union[str, os.PathLike, Dict[str, Any], HFConfig]


def load_config(source: ConfigSource) -> HFConfig:
    """Load a model config from a dict, a config.json path or a directory
    containing one. A HuggingFace repo id is refused: this package never
    touches the network (fetch the ``config.json`` and pass its path).
    """
    if isinstance(source, HFConfig):
        return source
    if isinstance(source, dict):
        return HFConfig(source)

    path = Path(source)
    if path.is_dir():
        path = path / "config.json"
    if path.is_file():
        with open(path, "r") as f:
            return HFConfig(json.load(f))
    raise RuntimeError(
        f"{source!r} is not a local config path; distilp_torch does not "
        "download configs: pass a config dict or a path to config.json"
    )


def load_config_from_repo(repo_id: str) -> HFConfig:
    """Reference-parity name (models.py:367); local paths only, a repo id
    raises (no network)."""
    return load_config(repo_id)
