"""Analytic memory model of the HALDA LP engines.

The port's copy of ``distilp_tpu/ops/memmodel.py``: the same formulas and
public names, stdlib only. They are byte counts of the dense HALDA standard
form, with no device constant in them:
``m_rows = 6M + 3`` constraint rows (w/n/y blocks + cycle/memory/prefetch
+ couplers) and ``n_cols ~ 3M`` variables. The engines' unavoidable
per-iteration working sets differ structurally:

- **IPM**: ``beam`` batched dense (m, m) f32 normal matrices — the
  factorizing engine's quadratic wall (beam = the B&B LP batch width);
- **PDHG**: ONE shared (m, n) f32 operator — matrix-free in iterates,
  so the operator itself is the footprint (and the thing the row mesh
  shards away).

The cross-shard combiner prices its lane cap with ``peak_bytes``
(``combine.policy.BucketPolicy.lane_cap``), and the ``memory`` report
prints ``peak_bytes`` beside the memory ledger's measured allocations. The
model is dense; the card's solves read A through its sparse structure and
keep buffers the model leaves out (loop plans, the packed static half), so
the measured-to-analytic ratio is far from 1 and is reported, not gated.
"""

from __future__ import annotations

from typing import Optional

__all__ = [
    "DENSE_BEAM",
    "F32_BYTES",
    "F64_BYTES",
    "ENGINES",
    "standard_form_dims",
    "ipm_peak_bytes",
    "pdhg_peak_bytes",
    "pdhg_shard_peak_bytes",
    "choose_mesh_shards",
    "dtype_bytes_of",
    "peak_bytes",
    "peak_gb",
    "ipm_memory_infeasible",
]

# The dense default_search_params beam — the IPM's LP batch size.
DENSE_BEAM = 6
F32_BYTES = 4
F64_BYTES = 8


def dtype_bytes_of(pdhg_dtype: Optional[str]) -> int:
    """Bytes per element of a ``pdhg_dtype`` knob value (None = the f32
    search dtype the solver runs by default)."""
    if pdhg_dtype in (None, "f32"):
        return F32_BYTES
    if pdhg_dtype == "f64":
        return F64_BYTES
    raise ValueError(f"unknown pdhg_dtype {pdhg_dtype!r} (expected f32|f64)")

ENGINES = ("ipm", "pdhg")


def standard_form_dims(M: int) -> tuple:
    """(m_rows, n_cols) of the dense HALDA standard form at fleet size M:
    m = 6M+3 constraint rows, n ~ 3M variables."""
    if M < 1:
        raise ValueError(f"fleet size must be >= 1 (got {M})")
    return 6 * M + 3, 3 * M


def ipm_peak_bytes(
    M: int, beam: int = DENSE_BEAM, dtype_bytes: int = F32_BYTES
) -> int:
    """The IPM's peak working set: ``beam`` batched (m, m) normal
    matrices — the quadratic term that makes M=4096 memory-infeasible."""
    m_rows, _ = standard_form_dims(M)
    return beam * m_rows * m_rows * dtype_bytes


def pdhg_peak_bytes(M: int, dtype_bytes: int = F32_BYTES) -> int:
    """PDHG's peak working set: the ONE shared (m, n) operator (iterates
    are vectors; A is only touched through opA/opAT — the fleet-scale
    invariant)."""
    m_rows, n_cols = standard_form_dims(M)
    return m_rows * n_cols * dtype_bytes


def pdhg_shard_peak_bytes(
    M: int, shards: int = 1, dtype_bytes: int = F32_BYTES
) -> int:
    """Per-DEVICE peak working set of the row-sharded PDHG engine
    (ops/meshlp.py): each shard holds an ``(ceil(m/S), n)`` block of the
    one shared operator — the row padding to a multiple of S is modeled
    exactly, since the pad rows are real zero rows in the block. Iterates
    are vectors (noise next to the block) and the f64 certificate is two
    matvec passes over the same block at 2x element width, both absorbed
    by the calibration band rather than modeled as separate terms — the
    same single-dominant-term shape as ``pdhg_peak_bytes``, which this
    reduces to at shards=1."""
    if shards < 1:
        raise ValueError(f"mesh_shards must be >= 1 (got {shards})")
    m_rows, n_cols = standard_form_dims(M)
    m_block = -(-m_rows // shards)  # ceil: the padded per-shard rows
    return m_block * n_cols * dtype_bytes


def choose_mesh_shards(
    M: int,
    per_device_budget_bytes: int,
    max_shards: int,
    dtype_bytes: int = F32_BYTES,
) -> Optional[int]:
    """Smallest shard count whose per-device operator block fits the
    budget (model-predicted). Returns None when
    even ``max_shards`` devices cannot fit a block: the caller should say
    so rather than OOM measuring it. shards=1 (no mesh) is preferred when
    it fits — the unsharded program has no collectives to pay for."""
    if max_shards < 1:
        raise ValueError(f"max_shards must be >= 1 (got {max_shards})")
    if per_device_budget_bytes < 1:
        raise ValueError("per_device_budget_bytes must be positive")
    for shards in range(1, max_shards + 1):
        if pdhg_shard_peak_bytes(M, shards, dtype_bytes) <= per_device_budget_bytes:
            return shards
    return None


def peak_bytes(M: int, engine: str, beam: int = DENSE_BEAM) -> int:
    """Per-(M, engine) analytic peak working set in bytes."""
    if engine == "ipm":
        return ipm_peak_bytes(M, beam=beam)
    if engine == "pdhg":
        return pdhg_peak_bytes(M)
    raise ValueError(f"unknown LP engine {engine!r} (expected ipm|pdhg)")


def peak_gb(M: int, engine: str, beam: int = DENSE_BEAM) -> float:
    """``peak_bytes`` in (decimal) gigabytes."""
    return peak_bytes(M, engine, beam=beam) / 1e9


def ipm_memory_infeasible(
    M: int, cap_gb: float, beam: int = DENSE_BEAM
) -> Optional[str]:
    """A human-readable reason when the IPM's proxy exceeds ``cap_gb``,
    else None."""
    gb = peak_gb(M, "ipm", beam=beam)
    if gb > cap_gb:
        return (
            f"memory-infeasible (~{gb:.1f} GB batched "
            f"normal matrices > {cap_gb:g} GB cap)"
        )
    return None
