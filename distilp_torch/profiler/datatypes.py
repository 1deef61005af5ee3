"""Raw device-info schema produced by the microbenchmarks.

The port's copy of the JAX package's schema (the same fields, so a raw
``DeviceInfo`` JSON loads in both packages). It is a wire-compatible superset
of upstream distilp's ``DeviceInfo`` tree
(src/distilp/profiler/datatypes.py:5-123), with these changes:

- ``GPUInfo.name`` admits ``"tpu"`` — the accelerator this framework targets.
- ``CPUFeatures`` actually has the ``AVX2``/``NEON`` fields the reference's
  x86 probe tries to set (its schema lacks them, so the probe raises on
  pydantic v2 — reference profiler/device.py:53,58 vs datatypes.py:16-21;
  fixed here).
- ``InterconnectInfo`` is new: measured/derived ICI-DCN characteristics that
  replace the reference's hand-edited per-device ``t_comm`` scalar
  (common/device.py:50).
"""

from __future__ import annotations

from typing import Dict, Literal

from pydantic import BaseModel, Field


class CPUTopology(BaseModel):
    packages: int = 1
    cores: int = 0
    threads: int = 0


class CPUClock(BaseModel):
    base: float = 0.0  # MHz
    max: float = 0.0  # MHz


class CPUFeatures(BaseModel):
    AVX: bool = False
    AVX2: bool = False
    FMA: bool = False
    BF16: bool = False
    SSE: bool = False
    NEON: bool = False


class CPUCache(BaseModel):
    l1d: int = 0
    l1i: int = 0
    l2: int = 0
    l3: int = 0


class Stat(BaseModel):
    """Distribution of one microbenchmark's timed samples (seconds).

    The reference prints p50/p95/p99 at debug>=1 and then discards them
    (upstream distilp src/distilp/profiler/profiler/device.py:188-197); here
    the spread is carried on the profile so a consumer can judge whether a
    throughput entry is trustworthy. ``valid=False`` marks a measurement
    whose net time was within the dispatch round-trip noise — its derived
    throughput is NOT stored (the table keeps the 0.0 "no table" sentinel
    instead of an absurd number).
    """

    samples: int = 0
    min: float = 0.0
    p50: float = 0.0
    p95: float = 0.0
    p99: float = 0.0
    max: float = 0.0
    mean: float = 0.0
    stddev: float = 0.0
    baseline: float = 0.0  # subtracted dispatch/fetch round-trip floor
    valid: bool = True


class Batches(BaseModel):
    b_1: float = 0.0
    b_2: float = 0.0
    b_4: float = 0.0
    b_8: float = 0.0
    b_16: float = 0.0
    b_32: float = 0.0
    b_64: float = 0.0
    b_128: float = 0.0
    b_256: float = 0.0
    b_512: float = 0.0


class Benchmarks(BaseModel):
    f64: Batches = Field(default_factory=Batches)
    f32: Batches = Field(default_factory=Batches)
    tf32: Batches = Field(default_factory=Batches)
    fp16: Batches = Field(default_factory=Batches)
    bf16: Batches = Field(default_factory=Batches)
    u32: Batches = Field(default_factory=Batches)
    u16: Batches = Field(default_factory=Batches)
    u8: Batches = Field(default_factory=Batches)
    i32: Batches = Field(default_factory=Batches)
    i16: Batches = Field(default_factory=Batches)
    i8: Batches = Field(default_factory=Batches)


class SystemMemory(BaseModel):
    can_swap: int = 0
    total: float = 0.0
    available: float = 0.0
    total_swap: float = 0.0
    available_swap: float = 0.0
    cpu_read_cold_bw: float = 0.0
    cpu_read_warm_bw: float = 0.0
    cpu_write_cold_bw: float = 0.0
    cpu_write_warm_bw: float = 0.0
    memcpy_delay: float = 0.0  # ms


class DiskInfo(BaseModel):
    read: float = 0.0  # bytes/s
    write: float = 0.0  # bytes/s
    random: float = 0.0  # bytes/s


class CPUInfo(BaseModel):
    vendor: str = ""
    model: str = ""
    arch: str = ""
    topology: CPUTopology = Field(default_factory=CPUTopology)
    clock: CPUClock = Field(default_factory=CPUClock)
    cache: CPUCache = Field(default_factory=CPUCache)
    features: CPUFeatures = Field(default_factory=CPUFeatures)
    benchmarks: Benchmarks = Field(default_factory=Benchmarks)
    memcpy_hot: float = 0.0
    memcpy_cold: float = 0.0


class GPUMemory(BaseModel):
    name: str = ""
    free: float = 0
    total: float = 0
    read_bw: float = 0.0  # host->device bytes/s
    write_bw: float = 0.0  # device->host bytes/s
    read_write_bw: float = 0.0
    two_read_one_write_bw: float = 0.0
    vram_to_compute: float = 0.0  # device-memory streaming bytes/s
    unified_memory: bool = False
    # Where ``total``/``free`` came from: "memory_stats" (runtime-reported),
    # "table:<device kind>" (static per-chip HBM table), "env:DPERF_HBM_BYTES"
    # (operator override), or "unknown" (unlisted kind — capacity is 0 and
    # must not be trusted).
    capacity_source: str = ""


class GPUInfo(BaseModel):
    name: Literal["cuda", "metal", "tpu", ""] = ""
    memory: GPUMemory = Field(default_factory=GPUMemory)
    benchmarks: Benchmarks = Field(default_factory=Benchmarks)
    device_kind: str = ""  # e.g. "TPU v5e"
    num_devices: int = 0  # local devices visible to this host


class InterconnectInfo(BaseModel):
    """Measured/derived inter-device link characteristics (new vs reference).

    On a multi-device mesh these come from timed collectives over ICI; on a
    single-device host they stay 0 and ``t_comm`` falls back to the profile
    scalar, exactly as the reference behaves (profiler/device.py:719).
    """

    num_devices: int = 0
    num_slices: int = 1
    ici_allreduce_latency_s: float = 0.0  # small-message all-reduce time
    ici_bandwidth: float = 0.0  # bytes/s per link, large-message all-gather
    dcn_latency_s: float = 0.0  # cross-slice small-message latency (0 = unknown)
    dcn_bandwidth: float = 0.0  # bytes/s across slices (0 = unknown)
    topology: str = ""  # e.g. "2x4" when coords are available
    # Where the numbers came from (VERDICT r5 item 8): collectives timed on
    # a VIRTUAL host-platform mesh (xla_force_host_platform_device_count)
    # are fiction relative to any real link, and must not masquerade as
    # measured ICI/DCN characteristics once a profile is saved to disk.
    # "unmeasured" = never probed (the <2-device fallback), "virtual" =
    # probed over host-platform virtual devices, "measured" = probed over
    # real accelerator devices, "config" = hand-written fixture values.
    provenance: Literal["unmeasured", "virtual", "measured", "config"] = (
        "unmeasured"
    )


class DeviceInfo(BaseModel):
    os: str = ""  # platform.system().lower() or "" (unknown)
    cpu: CPUInfo = Field(default_factory=CPUInfo)
    gpu: GPUInfo = Field(default_factory=GPUInfo)
    disk: DiskInfo = Field(default_factory=DiskInfo)
    memory: SystemMemory = Field(default_factory=SystemMemory)
    interconnect: InterconnectInfo = Field(default_factory=InterconnectInfo)
    # Timing spread of each microbenchmark, keyed "<area>.<detail>" (e.g.
    # "gemm.tpu.bf16.b_8", "mem.cpu_read_warm"): the raw-measurement
    # observability the reference prints at debug>=1 and throws away.
    stats: Dict[str, Stat] = Field(default_factory=dict)
