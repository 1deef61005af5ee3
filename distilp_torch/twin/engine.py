"""Monte-Carlo perturbation engine of the digital twin (kernel K8).

One launch evaluates everything a robustness report needs, stacked on one
row axis of ``R = samples + M + 1`` rows:

- ``samples`` perturbation draws: mean-1 log-normal jitter on every device's
  compute throughput, link time, disk rate and memory headroom, and an
  optional straggler scenario (a device runs ``dropout_slowdown`` x slower
  with probability ``dropout_p``);
- one deterministic sensitivity row per device (that device alone degraded
  by ``degrade``);
- the unperturbed base row.

Each row goes through the pipeline-execution math of
``twin.model.simulate_placement`` (the host numpy oracle): spill need and
the violation flag, busy times, the cycle max and the latency.

Port of ``distilp_tpu/twin/engine.py::_build_kernel`` (``_eval_one`` and
``_mc``). On a CUDA tensor :func:`twin_mc` launches the hand-written kernel
(``kernels/csrc/twin_mc_kernel.cu``); on a CPU tensor it runs the plain
version, :func:`twin_mc_reference`, which is split into
:func:`draw_multipliers` (the random stream) and :func:`evaluate_rows` (the
per-row math) so a test can feed :func:`evaluate_rows` another generator's
draws.

Random numbers: Philox4x32-10 (Salmon et al., SC'11), keyed by the seed,
with the counter ``(device, row, stream, 0)``: a draw depends on (seed, row,
device, stream) alone, never on the launch shape, so the kernel and the
plain version draw the same bits. Stream 0 gives the compute and link
normals, stream 1 the disk and memory normals (Box-Muller in float64 from
two 53-bit uniforms in (0, 1] each), stream 2 the straggler uniform. The
draws are not ``jax.random``'s: against the JAX package the samples agree in
distribution, while the base and sensitivity rows, which draw nothing, agree
to rounding.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..obs.compile_ledger import instrument as _instrument
from .model import PlacementVectors

# Per-device vectors of a placement, in the row order of the packed (14, M)
# float64 matrix the kernel reads (twin_mc_kernel.cu's V_* enum).
VEC_FIELDS = (
    "compute0", "comm0", "off0", "prefetch0", "pen_set", "pen_vram",
    "ram_lhs0", "ram_rhs", "cuda_lhs0", "cuda_rhs", "metal_lhs0",
    "metal_rhs", "s_cap", "t_cap",
)

# Philox4x32 round multipliers and Weyl key increments (Random123).
PHILOX_M0 = 0xD2511F53
PHILOX_M1 = 0xCD9E8D57
PHILOX_W0 = 0x9E3779B9
PHILOX_W1 = 0xBB67AE85
PHILOX_ROUNDS = 10
MASK32 = 0xFFFFFFFF
TWO_PI = 6.283185307179586
STREAM_COMP_COMM, STREAM_DISK_MEM, STREAM_DROP = 0, 1, 2


def pack_vectors(vec: PlacementVectors, device) -> Tuple[torch.Tensor, Tuple[float, float, float]]:
    """(vecs (14, M) float64 on ``device``, (bp, k - 1, kappa))."""
    rows = np.stack([np.asarray(getattr(vec, f), dtype=np.float64) for f in VEC_FIELDS])
    vecs = torch.as_tensor(rows, dtype=torch.float64, device=device).contiguous()
    return vecs, (float(vec.bp), float(vec.k - 1), float(vec.kappa))


def seed_key(seed: int) -> Tuple[int, int]:
    """The Philox key (two 32-bit words) of a seed in [0, 2**64)."""
    seed = int(seed)
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed must lie in [0, 2**64), got {seed}")
    return seed & MASK32, seed >> 32


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product ``m * x`` (int64 tensors
    holding 32-bit values). The product overflows int64, so ``x`` is split
    into 16-bit halves: each partial product stays below 2**48."""
    p_lo = m * (x & 0xFFFF)
    p_hi = m * (x >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return ((p_hi >> 16) + (s >> 32)) & MASK32, s & MASK32


def philox4x32(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counters ``(c0, c1, c2, c3)`` (int64 tensors of
    32-bit values, broadcast together) under the key ``(k0, k1)``."""
    for r in range(PHILOX_ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform53(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """A float64 uniform in (0, 1] from two 32-bit words: 53 bits, plus one
    ulp, so that log(u) is finite and sigma = 0 gives multipliers of
    exactly 1."""
    x = ((hi << 21) | (lo >> 11)) + 1
    return x.to(torch.float64) * 2.0 ** -53


def _normal_pair(x0, x1, x2, x3):
    """Box-Muller: two standard normals from one Philox output."""
    u1, u2 = uniform53(x0, x1), uniform53(x2, x3)
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = TWO_PI * u2
    return r * torch.cos(th), r * torch.sin(th)


def _jitter(z: torch.Tensor, sigma: float) -> torch.Tensor:
    """Mean-1 log-normal multiplier exp(sigma z - sigma^2/2)."""
    return torch.exp(sigma * z - 0.5 * sigma * sigma)


def draw_multipliers(
    samples: int,
    M: int,
    seed: int,
    sigmas: Sequence[float],
    dropout_p: float,
    dropout_slowdown: float,
    device="cpu",
):
    """The sample rows' (comp, comm, disk, mem) multipliers, each
    (samples, M) float64, the straggler slowdown folded into comp."""
    k0, k1 = seed_key(seed)
    row = torch.arange(samples, dtype=torch.int64, device=device)[:, None]
    dev = torch.arange(M, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((), dtype=torch.int64, device=device)

    def stream(s: int):
        return philox4x32(dev, row, zero + s, zero, k0, k1)

    z_comp, z_comm = _normal_pair(*stream(STREAM_COMP_COMM))
    z_disk, z_mem = _normal_pair(*stream(STREAM_DISK_MEM))
    x0, x1, _, _ = stream(STREAM_DROP)
    straggler = uniform53(x0, x1) < dropout_p
    s_comp, s_comm, s_disk, s_mem = (float(s) for s in sigmas)
    comp = _jitter(z_comp, s_comp)
    comp = torch.where(straggler, comp * float(dropout_slowdown), comp)
    return comp, _jitter(z_comm, s_comm), _jitter(z_disk, s_disk), _jitter(z_mem, s_mem)


def fixed_rows(M: int, degrade: float, device="cpu"):
    """The (comp, comm, disk, mem) multipliers of the M sensitivity rows and
    the base row, each (M + 1, M): row j degrades device j's compute and
    link by ``degrade``; the last row is all ones."""
    f64 = torch.float64
    eye = torch.eye(M, dtype=f64, device=device)
    sens = torch.cat([1.0 + (degrade - 1.0) * eye, torch.ones(1, M, dtype=f64, device=device)])
    ones = torch.ones(M + 1, M, dtype=f64, device=device)
    return sens, sens, ones, ones


def evaluate_rows(
    vecs: torch.Tensor,
    scalars: Tuple[float, float, float],
    comp: torch.Tensor,
    comm: torch.Tensor,
    disk: torch.Tensor,
    mem: torch.Tensor,
):
    """(latency (R,) float64, violation (R,) bool) of R perturbed executions
    of one placement: ``_eval_one`` of the JAX package on stacked rows of
    (R, M) multipliers. ``vecs`` is :func:`pack_vectors`' (14, M) matrix,
    ``scalars`` its (bp, k - 1, kappa)."""
    d = dict(zip(VEC_FIELDS, vecs))
    bp, kfac, kappa = scalars
    comp_s = d["compute0"] * comp
    comm_s = d["comm0"] * comm
    off_s = d["off0"] * comm

    def drift(rhs):
        # Capacity drift scales positive headroom; rows in deficit and
        # inactive rows (a huge rhs) keep their value.
        return torch.where(rhs > 0.0, rhs * mem, rhs)

    zero = torch.zeros((), dtype=torch.float64, device=vecs.device)
    s_need = torch.maximum(
        zero,
        torch.ceil(torch.maximum(zero, d["ram_lhs0"] - drift(d["ram_rhs"])) / bp - 1e-12),
    )
    vram_deficit = torch.maximum(
        torch.maximum(zero, d["cuda_lhs0"] - drift(d["cuda_rhs"])),
        torch.maximum(zero, d["metal_lhs0"] - drift(d["metal_rhs"])),
    )
    t_need = torch.maximum(zero, torch.ceil(vram_deficit / bp - 1e-12))
    violation = (s_need > d["s_cap"] + 1e-9).any(1) | (t_need > d["t_cap"] + 1e-9).any(1)
    s_used = torch.minimum(s_need, d["s_cap"])
    t_used = torch.minimum(t_need, d["t_cap"])
    disk_s = (d["pen_set"] * s_used + d["pen_vram"] * t_used) * disk
    busy = comp_s + disk_s + off_s + comm_s
    cycle = (busy + 0.5 * d["prefetch0"] * disk).amax(1)
    latency = (comp_s + disk_s).sum(1) + kfac * cycle + comm_s.sum(1) + off_s.sum(1) + kappa
    return latency, violation


def twin_mc_reference(
    vecs: torch.Tensor,
    scalars: Tuple[float, float, float],
    samples: int,
    seed: int,
    sigmas: Sequence[float],
    dropout_p: float,
    dropout_slowdown: float,
    degrade: float,
):
    """Plain PyTorch version of K8 on ``vecs``' device: (latency (R,),
    violation (R,)) over [samples | M sensitivity rows | base row]."""
    M = vecs.shape[1]
    drawn = draw_multipliers(samples, M, seed, sigmas, dropout_p, dropout_slowdown,
                             vecs.device)
    fixed = fixed_rows(M, degrade, vecs.device)
    rows = [torch.cat([a, b]) for a, b in zip(drawn, fixed)]
    return evaluate_rows(vecs, scalars, *rows)


def twin_mc(
    vecs: torch.Tensor,
    scalars: Tuple[float, float, float],
    samples: int,
    seed: int,
    sigmas: Sequence[float],
    dropout_p: float,
    dropout_slowdown: float,
    degrade: float,
):
    """K8: the kernel on a CUDA ``vecs``, the plain version on a CPU one."""
    if kernels.on_cuda(vecs):
        return _twin_mc_kernel(vecs, scalars, samples, seed, sigmas, dropout_p,
                               dropout_slowdown, degrade)
    return twin_mc_reference(vecs, scalars, samples, seed, sigmas, dropout_p,
                             dropout_slowdown, degrade)


twin_mc = _instrument("twin.twin_mc", twin_mc)


def _twin_mc_kernel(vecs, scalars, samples, seed, sigmas, dropout_p, dropout_slowdown,
                    degrade):
    from ..kernels.build import library

    if vecs.dtype != torch.float64 or vecs.dim() != 2 or vecs.shape[0] != len(VEC_FIELDS):
        raise ValueError(
            f"vecs must be ({len(VEC_FIELDS)}, M) float64, got "
            f"{tuple(vecs.shape)} {vecs.dtype}"
        )
    if samples < 1:
        raise ValueError("samples must be >= 1")
    vecs = vecs.contiguous()
    M = vecs.shape[1]
    R = samples + M + 1
    if R >= 1 << 30:
        raise ValueError(f"{R} rows: the kernel counts rows in 32-bit integers")
    k0, k1 = seed_key(seed)
    lat = torch.empty(R, dtype=torch.float64, device=vecs.device)
    viol = torch.empty(R, dtype=torch.uint8, device=vecs.device)
    bp, kfac, kappa = scalars
    P = kernels.ptr
    err = library("twin_mc").dtk_twin_mc(
        P(vecs), M, samples, bp, kfac, kappa, *(float(s) for s in sigmas),
        float(dropout_p), float(dropout_slowdown), float(degrade), k0, k1,
        P(lat), P(viol), kernels.stream_handle(vecs.device),
    )
    kernels.check(err, "twin_mc")
    kernels.LAUNCHES["twin_mc"] += 1
    return lat, viol.bool()


def run_monte_carlo(
    vec: PlacementVectors,
    samples: int = 1024,
    seed: int = 0,
    sigma_compute: float = 0.08,
    sigma_comm: float = 0.15,
    sigma_disk: float = 0.10,
    sigma_mem: float = 0.0,
    dropout_p: float = 0.0,
    dropout_slowdown: float = 8.0,
    degrade: float = 1.25,
    device=None,
) -> Dict[str, object]:
    """One launch: MC samples + per-device sensitivity rows + base row.

    Returns numpy/Python values: ``latencies`` (samples,), ``violations``
    (samples,) bool, ``sens_latencies`` (M,), ``base_latency`` float,
    ``base_violation`` bool. Deterministic for a fixed seed (fixed-order
    sums, no atomics). ``device=None`` means cuda and raises without a GPU.
    """
    if samples < 1:
        raise ValueError("samples must be >= 1")
    dev = kernels.resolve_device(device, "run_monte_carlo")
    vecs, scalars = pack_vectors(vec, dev)
    lat, viol = twin_mc(
        vecs, scalars, int(samples), seed,
        (sigma_compute, sigma_comm, sigma_disk, sigma_mem),
        dropout_p, dropout_slowdown, degrade,
    )
    lat = lat.cpu().numpy()
    viol = viol.cpu().numpy()
    M = vecs.shape[1]
    return {
        "latencies": lat[:samples],
        "violations": viol[:samples],
        "sens_latencies": lat[samples : samples + M],
        "base_latency": float(lat[-1]),
        "base_violation": bool(viol[-1]),
    }

