"""Shared type vocabulary for profiles.

JSON-contract parity with the reference type vocabulary
(upstream distilp src/distilp/common/types.py:3-4): the set of quantization
labels and model phases is the wire format shared by profiler output and
solver input, so it must match exactly.
"""

from typing import Literal

ModelPhase = Literal["merged", "prefill", "decode"]

QuantizationLevel = Literal["Q4_K", "Q5_K", "Q6_K", "Q8_0", "BF16", "F16", "F32"]

# All quantization levels, in canonical order (useful for building throughput tables).
ALL_QUANT_LEVELS: tuple[QuantizationLevel, ...] = (
    "Q4_K",
    "Q5_K",
    "Q6_K",
    "Q8_0",
    "BF16",
    "F16",
    "F32",
)

# Bytes per element stored in the KV cache, by kv-cache quantization label.
# Parity: upstream distilp src/distilp/solver/halda_p_solver.py:39-56.
KV_BITS_FACTORS: dict[str, float] = {
    "4bit": 0.5,
    "8bit": 1.0,
    "fp16": 2.0,
    "bf16": 2.0,
}


def kv_bits_to_factor(kv_bits: str) -> float:
    """Map a kv-cache quantization label to bytes/element."""
    key = kv_bits.strip().lower()
    try:
        return KV_BITS_FACTORS[key]
    except KeyError:
        raise ValueError(
            f"Unsupported kv_bits {kv_bits!r}; expected one of {sorted(KV_BITS_FACTORS)}"
        ) from None
