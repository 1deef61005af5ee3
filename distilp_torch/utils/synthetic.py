"""Synthetic heterogeneous fleets for tests and benchmarks.

The golden fixtures top out at two devices; the north-star workloads
(BASELINE.md) are 16-32 device heterogeneous swarms. This generator produces
deterministic, plausible ``DeviceProfile`` fleets — a mix of Apple-silicon
laptops (mac_metal, unified memory), CUDA linux boxes and CPU-only
linux/android nodes — spanning roughly an order of magnitude in compute,
memory and disk speed.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..common import ALL_QUANT_LEVELS, DeviceProfile

# Relative throughput of each quant level vs F32 on typical hardware
# (coarse model: quantized kernels trade FLOPs for dequant work).
_QUANT_REL = {
    "Q4_K": 0.25,
    "Q5_K": 0.31,
    "Q6_K": 0.37,
    "Q8_0": 0.50,
    "F16": 1.15,
    "BF16": 1.15,
    "F32": 1.0,
}


def _throughput_table(f32_flops: float, batches=(1, 2, 4)) -> dict:
    return {
        q: {f"b_{b}": f32_flops * _QUANT_REL[q] * (1.0 + 0.02 * i) for i, b in enumerate(batches)}
        for q in ALL_QUANT_LEVELS
    }


def make_synthetic_fleet(
    M: int, seed: int = 0, pool_bytes: int = 0
) -> List[DeviceProfile]:
    """Deterministic heterogeneous fleet of M devices; device 0 is the head.

    ``pool_bytes > 0`` raises every memory pool (RAM and, where present,
    Metal/CUDA) to that capacity — MoE instances need fleets that can
    physically hold the resident expert set (expert residency is
    hard-capped; see ``solver.moe``).
    """
    rng = np.random.default_rng(seed)
    devices: List[DeviceProfile] = []
    kinds = ["mac_metal", "linux_cuda", "linux_cpu", "android"]
    for i in range(M):
        kind = kinds[i % len(kinds)]
        # Per-device scale factor: order-of-magnitude heterogeneity.
        scale = float(10 ** rng.uniform(-0.5, 0.5))
        cpu_f32 = 1.5e12 * scale
        ram = int(8e9 * scale)
        disk = 2.5e9 * scale
        t_comm = float(rng.uniform(0.02, 0.09))

        common = dict(
            name=f"synth-{kind}-{i}",
            is_head=(i == 0),
            scpu=_throughput_table(cpu_f32),
            T_cpu=4.5e10 * scale,
            t_kvcpy_cpu=5e-8,
            t_kvcpy_gpu=5e-8,
            t_comm=t_comm,
            s_disk=disk,
            d_avail_ram=ram,
            c_cpu=0,
            c_gpu=0,
        )
        if kind == "mac_metal":
            dev = DeviceProfile(
                os_type="mac_metal",
                is_unified_mem=True,
                has_metal=True,
                sgpu_metal=_throughput_table(2.6e12 * scale),
                T_metal=2.1e11 * scale,
                d_avail_metal=ram,
                **common,
            )
        elif kind == "linux_cuda":
            dev = DeviceProfile(
                os_type="linux",
                has_cuda=True,
                sgpu_cuda=_throughput_table(9e12 * scale),
                T_cuda=6e11 * scale,
                d_avail_cuda=int(1.2e10 * scale),
                t_ram2vram=2e-4,
                t_vram2ram=2e-4,
                **common,
            )
        elif kind == "android":
            dev = DeviceProfile(
                os_type="android",
                d_bytes_can_swap=2 << 30,
                d_swap_avail=1 << 30,
                **common,
            )
        else:
            dev = DeviceProfile(os_type="linux", **common)
        devices.append(dev)
    if pool_bytes > 0:
        for d in devices:
            d.d_avail_ram = int(pool_bytes)
            if d.d_avail_metal is not None:
                d.d_avail_metal = int(pool_bytes)
            if d.d_avail_cuda is not None:
                d.d_avail_cuda = int(pool_bytes)
    return devices


def stretch_model_for_fleet(model, M: int):
    """Fleet-scale synthetic instance from a profiled model: stretch the
    typical-layer scalars to ``L = 2·M`` layers. HALDA places every device
    (``w_i >= 1``), so an M-device instance needs a model at least as deep
    as the fleet; 2M keeps two k candidates feasible so the sweep still
    searches. Per-layer columns are dropped — the typical-layer scalars
    price every stretched layer. The ONE recipe shared by bench.py's
    ``fleet_scale`` section and the walkthrough's fleet-scale step, so the
    two always measure the same instance family."""
    return model.model_copy(update=dict(
        L=2 * M, b_layers=None, b_i_layers=None, b_o_layers=None,
        f_q_layers=None,
    ))
