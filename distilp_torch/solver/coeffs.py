"""HALDA coefficient model, vectorized as struct-of-arrays.

Turns ``(devices, model, kv_factor)`` into the dense numeric ingredients of the
per-k MILP: per-device latency coefficients, memory caps, disk penalties and
the additive constants. All downstream backends (scipy CPU oracle, JAX IPM +
branch-and-bound) consume the same :class:`HaldaCoeffs`, so numeric parity with
the reference lives in exactly one place.

Numeric parity targets (verified by golden-objective tests):
- resident-bytes model   upstream distilp src/distilp/solver/components/dense_common.py:25-46
- latency coefficients   dense_common.py:49-126
- device-set partition   dense_common.py:129-167
- objective vectors / κ  dense_common.py:170-230

Everything here is host-side numpy: the arrays are tiny (O(M)) and are
``device_put`` once by the JAX backend; the hot loops live on the accelerator.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..common import DeviceProfile, ModelProfile, QuantizationLevel, ThroughputTable

# Weight-residency overhead and KV-cache per-group metadata defaults.
# (rho_w ~ runtime overhead on weights; kv_group=64 -> +2 bytes scale per group.)
RHO_W = 0.15
KV_GROUP = 64


def valid_factors_of_L(L: int) -> List[int]:
    """All positive factors of L except L itself — the candidate segment counts k."""
    fs = set()
    for k in range(1, int(math.isqrt(L)) + 1):
        if L % k == 0:
            fs.add(k)
            fs.add(L // k)
    fs.discard(L)
    return sorted(fs)


def b_prime(
    model: ModelProfile,
    kv_bits_k: float = 1.0,
    kv_bits_v: Optional[float] = None,
    *,
    rho_w: float = RHO_W,
    kv_group: int = KV_GROUP,
) -> int:
    """Resident bytes of one layer: weights (with runtime overhead) + KV cache.

        b' = (1+rho_w)·b_layer + (1 + 2/kv_group)·(h_k·e_k·kv_k + h_v·e_v·kv_v)·n_kv

    kv_bits_* are bytes/element (0.5 = 4-bit, 1.0 = 8-bit, 2.0 = fp16/bf16).
    """
    if kv_bits_v is None:
        kv_bits_v = kv_bits_k
    kv_elems_k = model.hk * model.ek * model.n_kv
    kv_elems_v = model.hv * model.ev * model.n_kv
    kv_nominal = kv_bits_k * kv_elems_k + kv_bits_v * kv_elems_v
    group_scale = 1.0 + 2.0 / float(max(1, kv_group))
    weights = (1.0 + float(rho_w)) * float(model.b_layer)
    return int(weights + group_scale * kv_nominal)


def flops_over_flops_per_s(
    f_by_batch: Dict[str, float],
    table: Optional[ThroughputTable],
    q: QuantizationLevel,
    batch_size: int = 1,
) -> float:
    """Seconds of compute: f_q / s_q at one batch size.

    Missing quant level or missing f entry yields 0.0 (device can't be charged
    for work it has no table for); a table that has the level but not the
    batch column is a malformed profile and raises.
    """
    batch_key = f"b_{batch_size}"
    if table is None or batch_key not in f_by_batch or q not in table:
        return 0.0
    level = table[q]
    if batch_key not in level:
        raise ValueError(f"Batch column {batch_key!r} missing from throughput table for {q}")
    s = level[batch_key]
    if s <= 0:
        return 0.0
    return f_by_batch[batch_key] / s


def alpha_beta_xi(
    dev: DeviceProfile, model: ModelProfile, kv_factor: float = 1.0,
    batch_size: int = 1,
) -> tuple[float, float, float]:
    """Per-layer latency coefficients for one device.

    alpha = CPU seconds/layer: compute + KV copy + register loads.
    beta  = accelerator minus CPU delta (negative when the GPU is faster); 0
            without an accelerator table.
    xi    = host<->accelerator round-trip, charged only on split-memory devices.

    ``batch_size`` selects the ``b_N`` column of both the model's FLOPs
    tables and the device's throughput tables (default 1 — reference
    parity, which hard-wires ``b_1``; SURVEY §8 quirk 10).
    """
    bprime = b_prime(model, kv_bits_k=kv_factor)
    comp_cpu = flops_over_flops_per_s(
        model.f_q, dev.scpu, model.Q, batch_size=batch_size
    )
    alpha = comp_cpu + dev.t_kvcpy_cpu + bprime / dev.T_cpu

    gpu_table = dev.gpu_table()
    gpu_T = dev.gpu_T()
    if gpu_table is not None and gpu_T is not None:
        comp_gpu = flops_over_flops_per_s(
            model.f_q, gpu_table, model.Q, batch_size=batch_size
        )
        beta = (
            (comp_gpu - comp_cpu)
            + (dev.t_kvcpy_gpu - dev.t_kvcpy_cpu)
            + (bprime / gpu_T - bprime / dev.T_cpu)
        )
    else:
        beta = 0.0

    xi = (dev.t_ram2vram + dev.t_vram2ram) * (0.0 if dev.is_unified_mem else 1.0)
    return alpha, beta, xi


def b_cio(dev: DeviceProfile, model: ModelProfile) -> float:
    """Non-layer resident bytes: head's input/output layers + CPU scratch."""
    head = 1.0 if dev.is_head else 0.0
    return (model.b_in / model.V + model.b_out) * head + dev.c_cpu


def classify_device(dev: DeviceProfile) -> int:
    """Memory-pressure case 1..3 by OS/backend.

    1: macOS without Metal (weights stream through RAM only)
    2: macOS with Metal (unified memory budget)
    3: everything else (Linux/Android/TPU hosts: RAM + optional swap)
    A "case 4 / fits in RAM" set exists in the paper but is never produced by
    the reference partitioner; we match that behavior.
    """
    if dev.os_type == "mac_no_metal":
        return 1
    if dev.os_type == "mac_metal":
        return 2
    return 3


def assign_sets(devs: Sequence[DeviceProfile]) -> Dict[str, List[int]]:
    """Partition device indices into the M1/M2/M3 cases."""
    sets: Dict[str, List[int]] = {"M1": [], "M2": [], "M3": []}
    for i, d in enumerate(devs):
        sets[f"M{classify_device(d)}"].append(i)
    return sets


def _swap_bytes(dev: DeviceProfile) -> int:
    """Swap headroom counted toward RAM capacity (Android only)."""
    if dev.os_type == "android":
        return min(dev.d_bytes_can_swap, dev.d_swap_avail)
    return 0


@dataclass
class HaldaCoeffs:
    """Everything the per-k MILP needs, as dense per-device arrays.

    k enters only through W = L/k: the Σw equality RHS and the [1, W] /
    [0, W] variable bounds. All arrays below are k-independent, which is what
    makes the k-sweep a pure vmap on the JAX backend.
    """

    M: int
    L: int
    bprime: float
    # Objective / busy-time coefficients (seconds per layer)
    a: np.ndarray  # CPU path sec/layer
    b_gpu: np.ndarray  # GPU-minus-CPU delta sec/layer (0 without GPU)
    xi: np.ndarray  # host<->accelerator round-trip constant
    t_comm: np.ndarray  # per-device inter-device comm seconds
    # Disk
    s_disk: np.ndarray  # clamped >= 1 byte/s for penalty math
    pen_m1: np.ndarray  # b'/s_disk
    pen_m2: np.ndarray  # b_layer/s_disk
    pen_m3: np.ndarray  # b'/s_disk
    pen_vram: np.ndarray  # set-2 devices pay pen_m2, others pen_m3
    # Set membership and accelerator structure
    set_id: np.ndarray  # 1 | 2 | 3
    has_gpu: np.ndarray  # bool: any accelerator layers allowed (n_i can be > 0)
    # Memory caps (RHS of the capacity rows)
    ram_rhs: np.ndarray  # per-device RAM/unified cap minus resident overheads
    ram_minus_n: np.ndarray  # bool: subtract b'·n_i from RAM residency (set 3)
    cuda_row: np.ndarray  # bool: CUDA VRAM row active
    cuda_rhs: np.ndarray
    metal_row: np.ndarray  # bool: Metal shared-memory row active
    metal_rhs: np.ndarray
    # Constants
    kappa: float
    sets: Dict[str, List[int]] = field(default_factory=dict)

    @property
    def busy_const(self) -> np.ndarray:
        """Per-device constant inside the busy time B_i: xi_i + t_comm_i."""
        return self.xi + self.t_comm

    @property
    def obj_const(self) -> float:
        """Additive objective constant: Σ t_comm + Σ xi + κ."""
        return float(self.t_comm.sum() + self.xi.sum() + self.kappa)


def kappa_constant(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    sets: Dict[str, List[int]],
    batch_size: int = 1,
) -> float:
    """Constant objective terms: head-device I/O-layer costs + tail RAM deficits."""
    head_idx = next((i for i, d in enumerate(devs) if d.is_head), 0)
    head = devs[head_idx]

    head_compute = flops_over_flops_per_s(
        model.f_out, head.scpu, model.Q, batch_size=batch_size
    )
    head_load_regs = (model.b_in / model.V + model.b_out) / head.T_cpu
    head_disk_in = model.b_in / (model.V * head.s_disk)
    head_disk_out = model.b_out / head.s_disk

    tail = 0.0
    for i in sets.get("M1", []) + sets.get("M3", []):
        d = devs[i]
        tail += (d.c_cpu - d.d_avail_ram - _swap_bytes(d)) / d.s_disk

    return head_compute + head_load_regs + head_disk_in + head_disk_out + tail


def build_coeffs(
    devs: Sequence[DeviceProfile],
    model: ModelProfile,
    kv_factor: float,
    sets: Optional[Dict[str, List[int]]] = None,
    batch_size: int = 1,
) -> HaldaCoeffs:
    """Assemble the full coefficient struct for one (devices, model) instance.

    ``batch_size`` (opt-in, default 1 = reference parity) prices the dense
    compute at the model's and devices' ``b_N`` throughput columns, for
    prefill-heavy deployments whose real batch is not 1. The model profile
    must carry the requested column (profile with ``batch_sizes=[..., N]``).
    """
    M = len(devs)
    if batch_size != 1:
        # Validate BOTH FLOPs tables the batch column is read from: a
        # missing key silently prices that compute term at 0.0
        # (flops_over_flops_per_s), which must never happen on an
        # explicitly requested batch.
        for fname, fdict in (("f_q", model.f_q), ("f_out", model.f_out)):
            if f"b_{batch_size}" not in fdict:
                raise ValueError(
                    f"batch_size={batch_size} requested but the model "
                    f"profile's {fname} has no 'b_{batch_size}' FLOPs column "
                    f"(has: {sorted(fdict)}); re-profile the model with "
                    f"batch_sizes=[{batch_size}, ...]"
                )
    if sets is None:
        sets = assign_sets(devs)
    bprime = float(b_prime(model, kv_bits_k=kv_factor))

    a = np.zeros(M)
    b_gpu = np.zeros(M)
    xi = np.zeros(M)
    t_comm = np.zeros(M)
    s_disk = np.zeros(M)
    set_id = np.zeros(M, dtype=np.int32)
    has_gpu = np.zeros(M, dtype=bool)
    ram_rhs = np.zeros(M)
    ram_minus_n = np.zeros(M, dtype=bool)
    cuda_row = np.zeros(M, dtype=bool)
    cuda_rhs = np.zeros(M)
    metal_row = np.zeros(M, dtype=bool)
    metal_rhs = np.zeros(M)

    set_of = {}
    for name, idxs in sets.items():
        for i in idxs:
            set_of[i] = int(name[1])

    for i, d in enumerate(devs):
        alpha, beta, xi_i = alpha_beta_xi(d, model, kv_factor, batch_size)
        sid = set_of.get(i, 3)
        set_id[i] = sid
        # The set partition zeroes the GPU delta for set-1 devices (no Metal on
        # a mac without Metal) and keeps it elsewhere.
        a[i] = alpha
        b_gpu[i] = 0.0 if sid == 1 else beta
        xi[i] = xi_i
        t_comm[i] = d.t_comm
        s_disk[i] = max(1.0, float(d.s_disk))
        has_gpu[i] = d.has_gpu_backend()

        bcio_i = b_cio(d, model)
        if sid == 1:
            ram_rhs[i] = float(d.d_avail_ram) - bcio_i
        elif sid == 2:
            if d.d_avail_metal is None:
                # No usable cap row; keep it trivially inactive.
                ram_rhs[i] = np.inf
            else:
                ram_rhs[i] = float(d.d_avail_metal) - bcio_i - float(d.c_gpu)
        else:
            ram_rhs[i] = float(d.d_avail_ram + _swap_bytes(d)) - bcio_i
            ram_minus_n[i] = True

        # Discrete accelerator memory cap (CUDA in the reference; TPU HBM
        # fills the same role here — separate memory, so the same row shape).
        if d.has_tpu and d.d_avail_tpu is not None:
            cuda_row[i] = True
            cuda_rhs[i] = float(d.d_avail_tpu) - float(d.c_gpu)
        elif d.has_cuda and d.d_avail_cuda is not None:
            cuda_row[i] = True
            cuda_rhs[i] = float(d.d_avail_cuda) - float(d.c_gpu)
        if d.has_metal and d.d_avail_metal is not None:
            metal_row[i] = True
            head = 1.0 if d.is_head else 0.0
            metal_rhs[i] = (
                float(d.d_avail_metal) - float(d.c_gpu) - float(model.b_out) * head
            )

    pen_m1 = bprime / s_disk
    pen_m2 = float(model.b_layer) / s_disk
    pen_m3 = bprime / s_disk
    pen_vram = np.where(set_id == 2, pen_m2, pen_m3)

    return HaldaCoeffs(
        M=M,
        L=model.L,
        bprime=bprime,
        a=a,
        b_gpu=b_gpu,
        xi=xi,
        t_comm=t_comm,
        s_disk=s_disk,
        pen_m1=pen_m1,
        pen_m2=pen_m2,
        pen_m3=pen_m3,
        pen_vram=pen_vram,
        set_id=set_id,
        has_gpu=has_gpu,
        ram_rhs=ram_rhs,
        ram_minus_n=ram_minus_n,
        cuda_row=cuda_row,
        cuda_rhs=cuda_rhs,
        metal_row=metal_row,
        metal_rhs=metal_rhs,
        kappa=kappa_constant(devs, model, sets, batch_size),
        sets={k: list(v) for k, v in sets.items()},
    )
