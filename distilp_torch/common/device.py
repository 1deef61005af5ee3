"""Device profile schema: the JSON contract between device profiling and the solver.

Field names, types and defaults are wire-compatible with the reference schema
(upstream distilp src/distilp/common/device.py:12-93) — golden fixture JSONs
must validate unchanged. Comments keep the paper-symbol mapping so the solver
math stays auditable against prima.cpp (arXiv:2504.08791) notation.
"""

from __future__ import annotations

from typing import Dict, Optional

from pydantic import BaseModel, Field

from .types import QuantizationLevel

# {quant level -> {"b_<batch>": FLOPS}} throughput table.
ThroughputTable = Dict[QuantizationLevel, Dict[str, float]]


class DeviceProfile(BaseModel):
    """One device's measured characteristics, as consumed by the HALDA solver.

    Produced by the device profiler (or hand-written for fleets),
    consumed by the solver. All fields default so the profiler can
    build the record incrementally; the solver expects a fully populated one.
    """

    # Identity
    name: str = ""
    os_type: str = ""  # 'mac_no_metal' | 'mac_metal' | 'linux' | 'android' | 'tpu'
    is_head: bool = True  # I_{m=1}: head device owns the input/output layers
    is_unified_mem: bool = False  # I_UMA: unified host/accelerator memory
    has_cuda: bool = False
    has_metal: bool = False
    has_tpu: bool = False  # extension: TPU accelerator attached to this host

    # CPU compute: s^{cpu}_{m,q} FLOPS table per quant level and batch,
    # and T^{cpu}_m register-load throughput in bytes/s.
    scpu: ThroughputTable = Field(default_factory=dict)
    T_cpu: float = 0.0

    # KV-cache copy time (seconds) for the fixed probe payload.
    t_kvcpy_cpu: float = 0.0
    t_kvcpy_gpu: float = 0.0

    # Host<->accelerator and inter-device transfer times (seconds).
    t_ram2vram: float = 0.0
    t_vram2ram: float = 0.0
    t_comm: float = 0.0  # t^{comm}_m: per-round inter-device communication time
    # Interconnect link shape behind t_comm (extension; 0 = unmeasured).
    # t_comm above is latency + activation_payload/bandwidth at profile time;
    # carrying the two terms lets the solver price OTHER payloads (e.g. the
    # MoE all-to-all token dispatch) on the same measured link instead of
    # reusing the scalar for every message size.
    comm_latency: float = 0.0  # seconds, small-message collective latency
    comm_bandwidth: float = 0.0  # bytes/s, sustained large-message link rate

    # Disk read throughput s^{disk}_m (bytes/s).
    s_disk: float = 0.0

    # Capacities (bytes).
    d_avail_ram: int = 0

    # Accelerator compute tables and capacities (None when absent).
    sgpu_cuda: Optional[ThroughputTable] = None
    sgpu_metal: Optional[ThroughputTable] = None
    sgpu_tpu: Optional[ThroughputTable] = None
    T_cuda: Optional[float] = None
    T_metal: Optional[float] = None
    T_tpu: Optional[float] = None
    d_avail_cuda: Optional[int] = None
    d_avail_metal: Optional[int] = None
    d_avail_tpu: Optional[int] = None

    # Compute scratch buffers (bytes), reserved out of the memory caps.
    c_cpu: int = 0
    c_gpu: int = 0

    # Swap headroom (Android only in practice).
    d_bytes_can_swap: int = 0
    d_swap_avail: int = 0

    def gpu_table(self) -> Optional[ThroughputTable]:
        """The accelerator FLOPS table the solver should use.

        TPU (this framework's extension) wins, then Metal over CUDA as in the
        reference (upstream distilp src/distilp/solver/components/dense_common.py:78-86).
        """
        if self.has_tpu and self.sgpu_tpu:
            return self.sgpu_tpu
        if self.has_metal and self.sgpu_metal:
            return self.sgpu_metal
        if self.has_cuda and self.sgpu_cuda:
            return self.sgpu_cuda
        return None

    def gpu_T(self) -> Optional[float]:
        """Accelerator register-load throughput, with the same preference order.

        Parity: upstream distilp src/distilp/solver/components/dense_common.py:89-97.
        """
        if self.has_tpu and self.T_tpu:
            return self.T_tpu
        if self.has_metal and self.T_metal:
            return self.T_metal
        if self.has_cuda and self.T_cuda:
            return self.T_cuda
        return None

    def has_gpu_backend(self) -> bool:
        """Whether any accelerator layers can be placed on this device (n_i > 0)."""
        return bool(
            (self.has_tpu and self.d_avail_tpu is not None)
            or (self.has_cuda and self.d_avail_cuda is not None)
            or (self.has_metal and self.d_avail_metal is not None)
        )

    def summary(self) -> str:
        """Human-readable one-device summary."""
        gib = 1024.0**3
        lines = [
            f"   OS Type: {self.os_type}",
            f"   RAM: {self.d_avail_ram / gib:.1f} GB",
            f"   Is Head: {self.is_head}",
            f"   Unified Memory: {self.is_unified_mem}",
        ]
        if self.has_cuda and self.d_avail_cuda:
            lines.append(f"   CUDA: {self.d_avail_cuda / gib:.1f} GB")
        if self.has_metal and self.d_avail_metal:
            lines.append(f"   Metal: {self.d_avail_metal / gib:.1f} GB")
        lines.append(f"   Disk Speed: {self.s_disk / 1024**2:.1f} MB/s")
        return "\n".join(lines)

    def print_summary(self) -> None:
        print(self.summary())
