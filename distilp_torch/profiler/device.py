"""Device profiler of the port: PyTorch/CUDA microbenchmarks -> DeviceInfo ->
DeviceProfile.

Port of ``distilp_tpu/profiler/device.py`` (same measurements, same
``DPERF_*`` knobs, same ``DeviceInfo`` and ``DeviceProfile`` mapping), with
the accelerator probes on a CUDA card:

- GEMM throughput per dtype and batch: a chain of steps with full-matrix
  feedback, each step ``y = x @ b; y / (max|y| + eps)`` kernel K9b
  (:func:`gemm_absmax_scale`: a hand-written product with the abs-max as
  its epilogue, then the scale). float32 runs on the FP32 pipes, without
  TF32 (the ``stats`` label says ``tf32_off``). A dtype the kernel does not
  take (integer types on CUDA, unsigned ones on the CPU) is decided before
  any launch and keeps the 0.0 "no table" value.
- HBM streaming rate: chained single-element rolls, kernel K9a
  (:func:`roll1`), ping-ponging between two resident buffers.
- Accelerator memory: ``torch.cuda.mem_get_info`` (the whole card, not a
  framework's preallocation share), ``capacity_source="cudaMemGetInfo"``.
- Host<->device transfers: copies of a pageable host tensor, as the JAX
  package's ``device_put`` of a numpy array is.
- Host memory from ``/proc/meminfo``; CPU probes are torch CPU operations;
  the disk probe is the reference's layer-sized file.

Every timed call forces completion by fetching one element of its output,
and a sub-noise reading stays NaN (``bench``), never clamped. Nothing here
catches a kernel's or a launch's failure.
"""

from __future__ import annotations

import gc
import math
import os
import platform
import statistics as stats
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from .. import kernels
from ..common import DeviceProfile
from ..common.types import QuantizationLevel
from .datatypes import Batches, DeviceInfo, Stat
from .hfconfig import HFConfig

_BATCH_TAGS = [f"b_{2**n}" for n in range(9)]
_GEMM_DTYPES = [("f32", "float32"), ("fp16", "float16"), ("bf16", "bfloat16"), ("u32", "uint32")]
# Integer matmuls PyTorch's CPU kernels take; CUDA's take none.
_CPU_INT_MATMUL = (torch.int8, torch.uint8, torch.int16, torch.int32, torch.int64)
GEMM_EPS = 1e-6
THREADS = 256
ROLL_BLOCKS = 132 * 16  # grid-stride: enough blocks to fill an H100
RESCALE_BLOCKS = 132 * 4  # grid-stride blocks of K9b's scale pass


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _quantile(sorted_times: List[float], q: float) -> float:
    idx = min(len(sorted_times) - 1, int(round(q * (len(sorted_times) - 1))))
    return sorted_times[idx]


def _fetch_one(out: Any) -> None:
    """Force completion of ``out`` by reading one element on the host (a CPU
    tensor or a host value is complete already)."""
    if isinstance(out, (tuple, list)):
        out = out[0]
    if isinstance(out, torch.Tensor) and out.device.type != "cpu":
        out.reshape(-1)[:1].tolist()


def bench(
    fn: Callable[[], Any],
    warmup: int = 3,
    iters: int = 10,
    baseline: float = 0.0,
    label: str = "",
    sink: Optional[Dict[str, Any]] = None,
) -> float:
    """Median wall-clock seconds of ``fn`` minus ``baseline`` (the fetch
    round-trip floor), with completion forced by fetching one element of the
    output (``distilp_tpu/profiler/device.py::bench``).

    Returns ``nan`` when the baseline-subtracted median is inside the
    measurement noise (non-positive, or smaller than the interquartile
    spread while a baseline is subtracted). ``sink[label]`` records the
    sample distribution as a ``Stat``; ``DPERF_DEBUG>=1`` prints it.
    """
    for _ in range(warmup):
        _fetch_one(fn())
    times: List[float] = []
    for _ in range(iters):
        t0 = time.perf_counter()
        _fetch_one(fn())
        times.append(time.perf_counter() - t0)

    srt = sorted(times)
    st = Stat(
        samples=len(times),
        min=srt[0],
        p50=stats.median(times),
        p95=_quantile(srt, 0.95),
        p99=_quantile(srt, 0.99),
        max=srt[-1],
        mean=stats.fmean(times),
        stddev=stats.pstdev(times) if len(times) > 1 else 0.0,
        baseline=baseline,
    )
    net = st.p50 - baseline
    # Jitter estimate: the interquartile spread (at iters=10 the p95 index
    # is the max sample, so p95-p50 would let one hiccup invalidate it).
    noise = _quantile(srt, 0.75) - _quantile(srt, 0.25)
    if net <= 0 or (baseline > 0 and net < noise):
        st.valid = False
    if sink is not None and label:
        sink[label] = st
    if _env_int("DPERF_DEBUG", 0) >= 1:
        import sys

        flag = "" if st.valid else "  [SUB-NOISE: discarded]"
        print(
            f"[dperf] {label or 'bench'}: n={st.samples} "
            f"min={st.min * 1e3:.3f}ms p50={st.p50 * 1e3:.3f}ms "
            f"p95={st.p95 * 1e3:.3f}ms p99={st.p99 * 1e3:.3f}ms "
            f"max={st.max * 1e3:.3f}ms baseline={baseline * 1e3:.3f}ms{flag}",
            file=sys.stderr,
        )
    return net if st.valid else float("nan")


def _rate(nbytes: float, seconds: float) -> float:
    """bytes/sec, with a sub-noise (NaN) or non-positive time mapped to 0.0."""
    if math.isnan(seconds) or seconds <= 0.0:
        return 0.0
    return nbytes / seconds


def _ms(seconds: float) -> float:
    """Milliseconds, with a sub-noise (NaN) measurement mapped to 0.0."""
    return 0.0 if math.isnan(seconds) else 1000.0 * seconds


def _fetch_baseline(device: torch.device) -> float:
    """Round-trip floor of one small operation + one-element fetch."""
    x = torch.ones(8, dtype=torch.float32, device=device)
    v = bench(lambda: x * 1.0, warmup=3, iters=10)
    return v if v == v else 0.0


def _chained_rate(
    fn: Callable[[int], Any],
    chain: int,
    units_per_iter: float,
    warmup: int,
    iters: int,
    baseline: float,
    label: str = "",
    sink: Optional[Dict[str, Any]] = None,
) -> float:
    """Units/second of a chained computation ``fn(chain_length)`` timed at
    two chain lengths; the slope cancels the launch and fetch overheads.
    Falls back to the single-point (baseline-subtracted) rate when jitter
    swamps the slope, and to 0.0 ("no table") when even that is inside the
    noise: never an absurd rate."""
    c_lo = max(1, chain // 4)
    t_hi = bench(lambda: fn(chain), warmup, iters,
                 label=f"{label}.hi" if label else "", sink=sink)
    t_lo = bench(lambda: fn(c_lo), warmup, iters,
                 label=f"{label}.lo" if label else "", sink=sink)
    dt = t_hi - t_lo
    if dt > 0:
        return units_per_iter * (chain - c_lo) / dt
    net = t_hi - baseline
    if net > 0:
        return units_per_iter * chain / net
    return 0.0


# -- K9a and K9b --------------------------------------------------------------


def roll1(x: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``torch.roll(x, 1)`` of a 1-D float32 tensor: kernel K9a into ``out``
    on a CUDA tensor, the plain version on a CPU one."""
    if kernels.on_cuda(x):
        return _roll1_kernel(x, out)
    return roll1_reference(x)


def roll1_reference(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, 1)


def _roll1_kernel(x: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    from ..kernels.build import library

    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError(f"roll1 takes a contiguous 1-D float32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if out is None:
        out = torch.empty_like(x)
    if out.shape != x.shape or out.dtype != x.dtype or not out.is_contiguous() \
            or out.device != x.device or out.data_ptr() == x.data_ptr():
        raise ValueError("roll1's out must be a distinct contiguous float32 tensor "
                         "of x's shape on x's device")
    if x.data_ptr() % 16 or out.data_ptr() % 16:
        raise ValueError("roll1 needs 16-byte aligned buffers")
    n = x.numel()
    blocks = max(1, min(ROLL_BLOCKS, (n // 4 + THREADS - 1) // THREADS))
    err = library("profiler").dtk_roll1(kernels.ptr(x), kernels.ptr(out), n, blocks,
                                        kernels.stream_handle(x.device))
    kernels.check(err, "hbm_stream")
    kernels.LAUNCHES["hbm_stream"] += 1
    return out


def gemm_absmax_scale(x: torch.Tensor, b: torch.Tensor, eps: float = GEMM_EPS) -> torch.Tensor:
    """One step of the GEMM chain, ``y = x @ b; y / (max|y| + eps)``, for x
    of shape (..., K) and b of shape (K, N): kernel K9b on CUDA tensors (the
    product with the abs-max as its epilogue, then the scale in place), the
    plain version on CPU ones."""
    if kernels.on_cuda(x, b):
        y, partial = _gemm_absmax_kernel(x, b)
        _rescale_kernel(y, partial, eps)
        kernels.count_launch("gemm_absmax_scale", str(x.dtype).split(".")[-1])
        return y
    return gemm_absmax_scale_reference(x, b, eps)


def gemm_absmax_scale_reference(x: torch.Tensor, b: torch.Tensor,
                                eps: float = GEMM_EPS) -> torch.Tensor:
    return absmax_scale_reference(torch.matmul(x, b), eps)


def absmax_scale_reference(y: torch.Tensor, eps: float = GEMM_EPS) -> torch.Tensor:
    return y / (y.abs().amax() + eps)


_K9B_SUFFIX = {torch.float32: "f32", torch.float16: "f16", torch.bfloat16: "bf16"}
_K9B_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_INT32_MAX = 2**31 - 1


def gemm_tile(dtype: torch.dtype, M: int, N: int) -> tuple:
    """(rows, columns) of K9b's output tile for an (M, N) product in
    ``dtype``, as the kernel library lays it out on the current device
    (``dtk_gemm_tile``; the float32 product picks its tile from the shape):
    ``partial`` holds one abs-max per tile."""
    import ctypes

    from ..kernels.build import library

    rows, cols = ctypes.c_int(), ctypes.c_int()
    kernels.check(library("profiler").dtk_gemm_tile(
        _K9B_CODE[dtype], M, N, ctypes.byref(rows), ctypes.byref(cols)), "gemm_tile")
    return rows.value, cols.value


def gemm_partials(M: int, N: int, tile: tuple) -> int:
    """Number of output tiles of an (M, N) product: one partial each."""
    return -(-M // tile[0]) * -(-N // tile[1])


def _gemm_operands(x: torch.Tensor, b: torch.Tensor):
    """(M, N, K) of K9b's product, or raise on an operand the kernels do not
    take: both products (float32 on the FP32 pipes, float16/bfloat16 on the
    tensor cores) read x and b through TMA loads, which need a 16-byte
    aligned base and row strides that are multiples of 16 bytes (K and N
    multiples of 4 float32 or 8 16-bit values), rows that are the
    contiguous rows of the operand, and rows and coordinates that fit in
    32-bit signed integers."""
    if x.dtype not in _K9B_SUFFIX or b.dtype != x.dtype:
        raise TypeError(f"gemm_absmax_scale takes two float32, float16 or bfloat16 "
                        f"tensors of one dtype, got {x.dtype} and {b.dtype}")
    if x.dim() < 2 or b.dim() != 2 or x.shape[-1] != b.shape[0]:
        raise ValueError(f"gemm_absmax_scale multiplies (..., K) by (K, N), got "
                         f"{tuple(x.shape)} and {tuple(b.shape)}")
    K, N = b.shape
    vec = 16 // x.element_size()
    if not (x.is_contiguous() and b.is_contiguous()) or x.data_ptr() % 16 \
            or b.data_ptr() % 16 or K == 0 or K % vec or N % vec:
        raise ValueError(f"gemm_absmax_scale needs contiguous, 16-byte aligned "
                         f"operands with K > 0 and K and N multiples of {vec}, got "
                         f"K={K}, N={N}")
    M = x.numel() // K
    if max(M, N, K) > _INT32_MAX:
        raise ValueError(f"gemm_absmax_scale takes at most {_INT32_MAX} rows, columns "
                         f"and depth, got M={M}, N={N}, K={K}")
    return M, N, K


def _gemm_absmax_kernel(x: torch.Tensor, b: torch.Tensor):
    """K9b's product: (y = x @ b, the abs-max of each output tile of y)."""
    from ..kernels.build import library

    M, N, K = _gemm_operands(x, b)
    nparts = gemm_partials(M, N, gemm_tile(x.dtype, M, N))
    if nparts > _INT32_MAX:
        raise ValueError(f"gemm_absmax_scale takes at most {_INT32_MAX} output tiles, "
                         f"got {nparts}")
    y = torch.empty((*x.shape[:-1], N), dtype=x.dtype, device=x.device)
    partial = torch.empty(max(1, nparts), dtype=torch.float32, device=x.device)
    err = getattr(library("profiler"), f"dtk_gemm_absmax_{_K9B_SUFFIX[x.dtype]}")(
        kernels.ptr(x), kernels.ptr(b), kernels.ptr(y), M, N, K, kernels.ptr(partial),
        kernels.stream_handle(x.device),
    )
    kernels.check(err, "gemm_absmax_scale")
    return y, partial


def _rescale_kernel(y: torch.Tensor, partial: torch.Tensor, eps: float) -> torch.Tensor:
    """K9b's scale: y <- y / (max(partial) + eps) in place."""
    from ..kernels.build import library

    n = y.numel()
    blocks = max(1, min(RESCALE_BLOCKS, -(-n // (4 * THREADS))))
    err = getattr(library("profiler"), f"dtk_absmax_rescale_{_K9B_SUFFIX[y.dtype]}")(
        kernels.ptr(y), n, kernels.ptr(partial), partial.numel(), float(eps), blocks,
        kernels.stream_handle(y.device),
    )
    kernels.check(err, "gemm_absmax_scale")
    return y


# -- GEMM sweeps -----------------------------------------------------------------


def matmul_supported(device: torch.device, dtype: torch.dtype) -> bool:
    """Whether this device's product takes ``dtype``: on a CUDA card K9b's
    float32, float16 and bfloat16; on the CPU ``torch.matmul``'s float types
    and its signed integer types and uint8."""
    if device.type != "cpu":
        return dtype in _K9B_SUFFIX
    return dtype.is_floating_point or dtype in _CPU_INT_MATMUL


def _gemm_flops(
    device: torch.device,
    B: int,
    N: int,
    M: int,
    K: int,
    dtype_name: str,
    warmup: int,
    iters: int,
    baseline: float = 0.0,
    label: str = "",
    sink: Optional[Dict[str, Any]] = None,
) -> float:
    """FLOP/s of the batched GEMM ``(B,M,K) @ (K,N)`` on ``device``.

    0.0, the "no table" value, when this device's matmul does not take the
    dtype (decided before anything is launched) or when the measurement is
    sub-noise. Floats are timed as a chain of K9b steps with full-matrix
    feedback (each normalized product is the next input) at two chain
    lengths; integers (the CPU only) as one product reduced by max|.|.
    """
    device = torch.device(device)
    dtype = getattr(torch, dtype_name)
    if not matmul_supported(device, dtype):
        return 0.0
    flop = 2.0 * B * N * M * K
    if not dtype.is_floating_point:
        a = torch.ones((B, M, K), dtype=dtype, device=device)
        b = torch.ones((K, N), dtype=dtype, device=device)
        median = bench(lambda: torch.matmul(a, b).abs().amax(), warmup, iters,
                       baseline=baseline, label=label, sink=sink)
        result = flop / median if median == median else 0.0
    else:
        gen = torch.Generator(device=device).manual_seed(0)
        a = torch.randn((B, M, K), generator=gen, dtype=dtype, device=device)
        b = torch.randn((K, N), generator=gen, dtype=dtype, device=device)
        if device.type == "cpu":
            chain = _env_int("DPERF_CHAIN_CPU", 2)
        else:
            chain = max(4, _env_int("DPERF_CHAIN", 64) // B)

        def chained(c: int) -> torch.Tensor:
            x = a
            for _ in range(c):
                x = gemm_absmax_scale(x, b)
            return x

        result = _chained_rate(chained, chain, flop, warmup, iters, baseline,
                               label=label, sink=sink)
    del a, b
    gc.collect()
    return result


def run_host_benchmarks(di: DeviceInfo, n_embd: int, max_batch_exp: int) -> None:
    """CPU GEMM sweep (torch CPU matmul; size hidden/8, at least 512)."""
    size = int(n_embd / 8 if n_embd >= 4096 else 4096 / 8)
    warmup = _env_int("DPERF_GEMM_WARMUP", 1)
    iters = _env_int("DPERF_GEMM_ITERS", 4)
    cpu = torch.device("cpu")
    base = _fetch_baseline(cpu)
    for tag, dtype in _GEMM_DTYPES:
        table: Batches = getattr(di.cpu.benchmarks, tag)
        for exp in range(min(max_batch_exp, len(_BATCH_TAGS))):
            setattr(table, _BATCH_TAGS[exp], _gemm_flops(
                cpu, 2**exp, size, size, size, dtype, warmup, iters, base,
                label=f"gemm.cpu.{tag}.{_BATCH_TAGS[exp]}", sink=di.stats,
            ))


def run_accel_benchmarks(di: DeviceInfo, n_embd: int, max_batch_exp: int,
                         device: torch.device) -> None:
    """CUDA GEMM sweep through K9b (size hidden, at least 4096); float32 on
    the FP32 pipes, without TF32."""
    if device.type != "cuda":
        return
    size = n_embd if n_embd >= 4096 else 4096
    warmup = _env_int("DPERF_GEMM_WARMUP", 1)
    iters = _env_int("DPERF_GEMM_ITERS", 4)
    base = _fetch_baseline(device)
    for tag, dtype in _GEMM_DTYPES:
        table = getattr(di.gpu.benchmarks, tag)
        detail = f"{tag}.tf32_off" if tag == "f32" else tag
        for exp in range(min(max_batch_exp, len(_BATCH_TAGS))):
            setattr(table, _BATCH_TAGS[exp], _gemm_flops(
                device, 2**exp, size, size, size, dtype, warmup, iters, base,
                label=f"gemm.cuda.{detail}.{_BATCH_TAGS[exp]}", sink=di.stats,
            ))


# -- Host memory and identity ------------------------------------------------------


def read_meminfo(path: str = "/proc/meminfo") -> Dict[str, int]:
    """``/proc/meminfo`` in bytes (the kB fields times 1024), the numbers
    psutil's ``virtual_memory``/``swap_memory`` report on Linux."""
    out: Dict[str, int] = {}
    with open(path) as f:
        for line in f:
            key, _, rest = line.partition(":")
            parts = rest.split()
            if parts and parts[0].isdigit():
                scale = 1024 if len(parts) > 1 and parts[1] == "kB" else 1
                out[key.strip()] = int(parts[0]) * scale
    return out


def get_sysmem_info(di: DeviceInfo) -> None:
    """Host memory capacities and bandwidth probes (torch CPU operations)."""
    import numpy as np

    mi = read_meminfo()
    di.memory.total = mi.get("MemTotal", 0)
    di.memory.available = mi.get("MemAvailable", mi.get("MemFree", 0))
    di.memory.total_swap = mi.get("SwapTotal", 0)
    di.memory.available_swap = mi.get("SwapFree", 0)
    di.memory.can_swap = 1 if di.memory.total_swap > 0 else 0

    mb = _env_int("DPERF_MEM_MB", 128)
    n = (mb * 1024 * 1024) // 4
    A = torch.ones(n, dtype=torch.float32)
    nbytes = n * 4
    di.memory.cpu_read_cold_bw = _rate(
        nbytes, bench(lambda: A.max(), 0, 1, label="mem.cpu_read_cold", sink=di.stats))
    di.memory.cpu_read_warm_bw = _rate(
        nbytes, bench(lambda: A.sum(), 5, 10, label="mem.cpu_read_warm", sink=di.stats))

    def fill() -> torch.Tensor:
        return torch.full((n,), 23.4, dtype=torch.float32)

    di.memory.cpu_write_cold_bw = _rate(
        nbytes, bench(fill, 0, 1, label="mem.cpu_write_cold", sink=di.stats))
    di.memory.cpu_write_warm_bw = _rate(
        nbytes, bench(fill, 5, 10, label="mem.cpu_write_warm", sink=di.stats))

    # Seeded: the probe buffer's contents must not vary run to run.
    host_buf = np.random.default_rng(0).standard_normal(n // 8).astype(np.float32)
    di.memory.memcpy_delay = _ms(bench(
        lambda: torch.tensor(host_buf), 1, 5, label="mem.memcpy", sink=di.stats))
    del A, host_buf
    gc.collect()


def _cpu_topology() -> tuple:
    """(physical cores, logical CPUs) from /proc/cpuinfo (os.cpu_count()
    for the logical ones when it is unreadable)."""
    threads = os.cpu_count() or 0
    cores = set()
    try:
        with open("/proc/cpuinfo") as f:
            phys = core = None
            for line in f:
                key, _, val = line.partition(":")
                key = key.strip()
                if key == "physical id":
                    phys = val.strip()
                elif key == "core id":
                    core = val.strip()
                elif not line.strip():
                    if core is not None:
                        cores.add((phys, core))
                    phys = core = None
            if core is not None:
                cores.add((phys, core))
    except OSError:
        pass
    return (len(cores) or threads), threads


def _cpu_freq_mhz() -> tuple:
    """(min, max) MHz from cpufreq, else the current clock of /proc/cpuinfo."""
    base = Path("/sys/devices/system/cpu/cpu0/cpufreq")
    try:
        lo = int((base / "cpuinfo_min_freq").read_text()) / 1e3
        hi = int((base / "cpuinfo_max_freq").read_text()) / 1e3
        return lo, hi
    except (OSError, ValueError):
        pass
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("cpu MHz"):
                    mhz = float(line.partition(":")[2])
                    return mhz, mhz
    except (OSError, ValueError):
        pass
    return 0.0, 0.0


def fill_cpu_info(di: DeviceInfo) -> None:
    """CPU identity: topology and clock from /proc and /sys, the rest from
    py-cpuinfo where it is installed."""
    di.cpu.topology.cores, di.cpu.topology.threads = _cpu_topology()
    di.cpu.clock.base, di.cpu.clock.max = _cpu_freq_mhz()
    try:
        import cpuinfo  # py-cpuinfo
    except ImportError:
        di.cpu.model = platform.processor() or platform.machine()
        di.cpu.arch = platform.machine()
        return
    info = cpuinfo.get_cpu_info()
    di.cpu.vendor = info.get("vendor_id_raw", "")
    di.cpu.model = info.get("brand_raw", "")
    di.cpu.arch = info.get("arch_string_raw", platform.machine())
    flags = set(info.get("flags", []))
    di.cpu.features.AVX = "avx" in flags
    di.cpu.features.AVX2 = "avx2" in flags
    di.cpu.features.FMA = "fma" in flags
    di.cpu.features.SSE = "sse" in flags
    di.cpu.features.BF16 = "avx512_bf16" in flags or "amx_bf16" in flags
    di.cpu.features.NEON = "neon" in flags or platform.machine() in ("arm64", "aarch64")
    di.cpu.cache.l2 = int(info.get("l2_cache_size", 0) or 0)
    di.cpu.cache.l3 = int(info.get("l3_cache_size", 0) or 0)


# -- Accelerator memory, streaming rate and transfers ------------------------------


def accel_get_memory_info(di: DeviceInfo, device: torch.device) -> None:
    """The card's memory from cudaMemGetInfo (``torch.cuda.mem_get_info``):
    the whole card's free and total bytes, after this process's cached
    blocks (the probes' buffers) are handed back."""
    if device.type != "cuda":
        return
    torch.cuda.empty_cache()
    name = torch.cuda.get_device_name(device)
    di.gpu.memory.name = name
    di.gpu.device_kind = name
    di.gpu.num_devices = torch.cuda.device_count()
    free, total = torch.cuda.mem_get_info(device)
    di.gpu.memory.capacity_source = "cudaMemGetInfo"
    di.gpu.memory.total = float(total)
    di.gpu.memory.free = float(free)


def accel_bench_mem_to_compute(di: DeviceInfo, device: torch.device) -> None:
    """HBM streaming rate: chained K9a rolls over a resident float32 array
    of ``DPERF_HBM_MB`` MB (default 256), each pass reading and writing it
    once, timed at two chain lengths."""
    if device.type != "cuda":
        return
    mb = _env_int("DPERF_HBM_MB", 256)
    n = (mb * 1024 * 1024) // 4
    bufs = (torch.ones(n, dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.float32, device=device))
    chain = 8 * _env_int("DPERF_CHAIN", 8)

    def rolled(c: int) -> torch.Tensor:
        src, dst = bufs
        for _ in range(c):
            roll1(src, dst)
            src, dst = dst, src
        return src

    di.gpu.memory.vram_to_compute = _chained_rate(
        rolled, chain, 2 * n * 4, 2, 6, _fetch_baseline(device),
        label="hbm.stream", sink=di.stats,
    )
    del bufs
    gc.collect()


def bench_host_accel_transfers(di: DeviceInfo, n_embd: int, device: torch.device) -> None:
    """Host->device and device->host rates of ``DPERF_XFER_MB`` MB (default
    64) from and to pageable host memory."""
    if device.type != "cuda":
        return
    mb = _env_int("DPERF_XFER_MB", 64)
    n = (mb * 1024 * 1024) // 4
    host = torch.ones(n, dtype=torch.float32)
    nbytes = n * 4
    di.gpu.memory.read_bw = _rate(nbytes, bench(
        lambda: host.to(device), 1, 5, label="xfer.host_to_accel", sink=di.stats))
    resident = host.to(device)
    di.gpu.memory.write_bw = _rate(nbytes, bench(
        lambda: resident.cpu(), 1, 5, label="xfer.accel_to_host", sink=di.stats))
    if di.gpu.memory.read_bw > 0 and di.gpu.memory.write_bw > 0:
        di.gpu.memory.read_write_bw = 2.0 / (
            1.0 / di.gpu.memory.read_bw + 1.0 / di.gpu.memory.write_bw
        )
    del host, resident
    gc.collect()


# -- Disk benchmark ------------------------------------------------------------------


def _bytes_per_weight_from_config(config: Optional[Dict[str, Any]]) -> float:
    override = os.environ.get("DPERF_BYTES_PER_WEIGHT")
    if override:
        try:
            return float(override)
        except ValueError:
            pass
    if not config:
        return 2.0
    q = config.get("quantization") or config.get("quantization_config") or {}
    bits = 0
    if isinstance(q, dict):
        bits = int(q.get("bits", 0) or 0)
        if bits == 0 and q.get("quant_method") in ("mxfp4", "MXFP4", "mx_fp4"):
            bits = 4
    if bits == 0:
        dtype = config.get("torch_dtype") or config.get("dtype")
        bits = 32 if dtype in ("float32", "f32") else 16
    group = int(q.get("group_size", 0) or 0) if isinstance(q, dict) else 0
    per_weight = bits / 8.0
    if bits < 16 and group > 0:
        per_weight += 2.0 / group  # group scale metadata
    return per_weight


def _estimate_layer_file_bytes(config: Optional[Dict[str, Any]]) -> int:
    """~One decoder layer on disk: (4d^2 + 3di) params * bytes/weight."""
    overhead = _env_float("DPERF_LAYER_OVERHEAD", 1.05)
    min_mb = _env_int("DPERF_LAYER_MIN_MB", 16)
    max_mb = _env_int("DPERF_LAYER_MAX_MB", 1024)
    d = int((config or {}).get("hidden_size", 4096) or 4096)
    i = int((config or {}).get("intermediate_size", 4 * d) or 4 * d)
    params = 4 * d * d + 3 * d * i
    size = int(params * _bytes_per_weight_from_config(config) * overhead)
    return max(min_mb * 1024 * 1024, min(size, max_mb * 1024 * 1024))


def bench_disk_mainfs(di: DeviceInfo, config: Optional[Dict[str, Any]] = None) -> None:
    """Sequential write+read of a layer-sized file under ``TMPDIR``;
    ``random`` aliases ``read``; the page cache is dropped with
    posix_fadvise(DONTNEED) where available."""
    file_mb = os.environ.get("DPERF_DISK_FILE_MB")
    if file_mb:
        size = int(float(file_mb) * 1024 * 1024)
    else:
        size = _estimate_layer_file_bytes(config)
    chunk = _env_int("DPERF_DISK_CHUNK_MB", 8) * 1024 * 1024
    chunk = max(min(chunk, size), 1024 * 1024)

    path = Path(os.environ.get("TMPDIR", "/tmp")) / f"dperf_disk_{os.getpid()}.bin"
    data = os.urandom(min(chunk, size))
    try:
        t0 = time.perf_counter()
        written = 0
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        try:
            while written < size:
                written += os.write(fd, data[: min(chunk, size - written)])
            os.fsync(fd)
        finally:
            os.close(fd)
        di.disk.write = written / (time.perf_counter() - t0)

        fd = os.open(path, os.O_RDONLY)
        try:
            if hasattr(os, "posix_fadvise"):
                os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
            t0 = time.perf_counter()
            read_total = 0
            while True:
                buf = os.read(fd, chunk)
                if not buf:
                    break
                read_total += len(buf)
        finally:
            os.close(fd)
        di.disk.read = read_total / (time.perf_counter() - t0)
        di.disk.random = di.disk.read
    except OSError:
        pass
    finally:
        try:
            path.unlink(missing_ok=True)
        except OSError:
            pass


# -- Orchestration + DeviceProfile mapping ---------------------------------------------


def profile(config: HFConfig, max_batch_exp: int = 6, device=None) -> DeviceInfo:
    """Run every microbenchmark on this host and ``device`` (None = cuda,
    raising without a GPU; 'cpu' runs the host probes only)."""
    from .topology import measure_interconnect

    dev = kernels.resolve_device(device, "profile_device")
    if dev.type == "cuda":
        from ..kernels.build import load_all

        load_all()  # build and load the probe kernels before anything is timed
    di = DeviceInfo()
    di.os = platform.system().lower()
    get_sysmem_info(di)
    fill_cpu_info(di)

    hidden = config.hidden_size()
    run_host_benchmarks(di, hidden, max_batch_exp)
    run_accel_benchmarks(di, hidden, max_batch_exp, dev)
    accel_bench_mem_to_compute(di, dev)
    accel_get_memory_info(di, dev)
    bench_host_accel_transfers(di, hidden, dev)
    bench_disk_mainfs(di, config=config.raw)
    if dev.type == "cuda":
        di.gpu.name = "cuda"
    di.interconnect = measure_interconnect(device=dev)
    return di


def _quant_table(
    benchmarks, batch_keys: List[str]
) -> Dict[QuantizationLevel, Dict[str, float]]:
    """The per-quant throughput table from measured F32/F16/BF16 by the
    reference's fixed factors."""
    table: Dict[QuantizationLevel, Dict[str, float]] = {
        "Q4_K": {},
        "Q5_K": {},
        "Q6_K": {},
        "Q8_0": {},
        "F16": {},
        "BF16": {},
        "F32": {},
    }
    for key in batch_keys:
        f32 = getattr(benchmarks.f32, key)
        fp16 = getattr(benchmarks.fp16, key)
        bf16 = getattr(benchmarks.bf16, key)
        table["Q4_K"][key] = f32 * 0.25
        table["Q5_K"][key] = f32 * 0.31
        table["Q6_K"][key] = f32 * 0.37
        table["Q8_0"][key] = f32 * 0.5
        table["F16"][key] = fp16
        table["BF16"][key] = bf16
        table["F32"][key] = f32
    return table


def device_profile_from_info(
    di: DeviceInfo, config: HFConfig, max_batch_exp: int = 6, is_head: bool = True
) -> DeviceProfile:
    """The solver's ``DeviceProfile`` of a ``DeviceInfo`` this port measured
    (a CUDA card, ``gpu.name`` 'cuda', or none, ''): the mapping of
    ``distilp_tpu/profiler/device.py::profile_device``, field for field,
    several devices' timed collectives included (``t_comm``, ``comm_latency``,
    ``comm_bandwidth``). Other accelerators raise."""
    if di.gpu.name not in ("cuda", ""):
        raise ValueError(f"the port profiles CUDA cards only, got gpu.name={di.gpu.name!r}")
    ret = DeviceProfile()
    ret.name = platform.node() or "device"
    ret.has_cuda = di.gpu.name == "cuda"

    system = platform.system()
    if system == "Darwin":
        ret.os_type = "mac_no_metal"
    else:
        ret.os_type = "linux"
        if system == "Linux":
            try:
                with open("/proc/version", "r") as f:
                    if "android" in f.read().lower():
                        ret.os_type = "android"
            except OSError:
                pass

    ret.is_head = is_head

    batch_keys = [f"b_{2**n}" for n in range(max_batch_exp)]
    ret.scpu = _quant_table(di.cpu.benchmarks, batch_keys)
    # T_cpu divides the solver's memory terms and must stay positive: a
    # sub-noise warm read falls back to the cold read, then to 1 GB/s.
    ret.T_cpu = (
        di.memory.cpu_read_warm_bw or di.memory.cpu_read_cold_bw or 1e9
    )
    if ret.has_cuda:
        ret.sgpu_cuda = _quant_table(di.gpu.benchmarks, batch_keys)
        ret.T_cuda = di.gpu.memory.vram_to_compute

    # KV-copy payload: 2 * head_dim * kv_heads * 2 bytes.
    kv_payload = 2 * config.head_dim() * config.num_key_value_heads() * 2
    if di.memory.cpu_write_cold_bw > 0:
        ret.t_kvcpy_cpu = kv_payload / di.memory.cpu_write_cold_bw
    if ret.has_cuda and di.gpu.memory.vram_to_compute > 0:
        ret.t_kvcpy_gpu = kv_payload / di.gpu.memory.vram_to_compute

    transfer = 1024 * 1024
    if di.gpu.memory.read_bw > 0:
        ret.t_ram2vram = transfer / di.gpu.memory.read_bw
    if di.gpu.memory.write_bw > 0:
        ret.t_vram2ram = transfer / di.gpu.memory.write_bw

    # Inter-device communication from the timed collectives, with the
    # payload of one token's hidden state in bf16 (0 on one device); the link
    # terms ride along, chosen by the same rule as estimate_t_comm.
    if di.interconnect.num_devices > 1:
        from .topology import estimate_t_comm

        ret.t_comm = estimate_t_comm(config.hidden_size() * 2, info=di.interconnect)
        ic = di.interconnect
        if ic.num_slices > 1 and (ic.dcn_latency_s > 0 or ic.dcn_bandwidth > 0):
            ret.comm_latency = ic.dcn_latency_s
            ret.comm_bandwidth = ic.dcn_bandwidth
        else:
            ret.comm_latency = ic.ici_allreduce_latency_s
            ret.comm_bandwidth = ic.ici_bandwidth

    ret.s_disk = di.disk.read
    ret.d_avail_ram = int(di.memory.available)
    if ret.has_cuda:
        ret.d_avail_cuda = int(di.gpu.memory.free)

    ret.c_cpu = 0
    ret.c_gpu = 0
    ret.d_bytes_can_swap = int(di.memory.total_swap)
    ret.d_swap_avail = int(di.memory.available_swap)
    return ret


def profile_device(
    config: HFConfig,
    max_batch_exp: int = 6,
    is_head: bool = True,
    raw_info: Optional[List[DeviceInfo]] = None,
    device=None,
) -> DeviceProfile:
    """Microbenchmark this host and ``device`` and map the result to the
    solver's ``DeviceProfile``. ``raw_info`` (a list, appended to) receives
    the raw ``DeviceInfo`` (timing spreads, capacity provenance, the
    interconnect probe), which the CLI's ``--raw-out`` writes."""
    di = profile(config, max_batch_exp, device=device)
    if raw_info is not None:
        raw_info.append(di)
    return device_profile_from_info(di, config, max_batch_exp, is_head)
