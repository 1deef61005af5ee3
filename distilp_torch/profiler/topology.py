"""Interconnect probing of the port (``distilp_tpu/profiler/topology.py``):
the latency of a small all-reduce and the bandwidth of a large all-gather
over a mesh, timed through the port's collectives (K9c).

``measure_interconnect`` times the collectives over the shards of a
:class:`~distilp_torch.parallel.devices.Mesh` (or a list of devices): by
default every visible device of ``device``'s type. The numbers' provenance
is "measured" over distinct GPUs, "virtual" when shards share a device (or
are the CPU; they then time the device's own memory, not a link), and
"unmeasured" with one device and no mesh, where the solver keeps the
profile's scalar ``t_comm`` as the JAX package does below two devices.
Unlike the JAX package, a collective that fails raises: no zeros stand in
for a measurement that did not happen.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from .. import kernels
from ..parallel.collectives import AllReduce, all_gather
from ..parallel.devices import Mesh, make_mesh
from .datatypes import InterconnectInfo


def _as_mesh(devices) -> Mesh:
    if isinstance(devices, Mesh):
        return devices
    devs = tuple(torch.device(d) for d in devices)
    virtual = len(set(devs)) < len(devs) or any(d.type == "cpu" for d in devs)
    return Mesh(devs, virtual)


def _sub_mesh(mesh: Mesh, shards) -> Mesh:
    devs = tuple(mesh.devices[i] for i in shards)
    return Mesh(devs, mesh.virtual or len(set(devs)) < len(devs))


def measure_interconnect(
    latency_iters: int = 10,
    bandwidth_mb: int = 32,
    devices=None,
    slice_of=None,
    device=None,
) -> InterconnectInfo:
    """Time collectives over ``devices`` (a Mesh or a list of devices; None =
    every visible device of ``device``'s type, None = cuda). ``slice_of``
    maps a shard index to its island (default: one island, the host's
    NVLink domain); when the shards span several, a second pair of
    collectives over one shard per island gives the cross-island latency and
    bandwidth (the reference's DCN terms)."""
    if devices is None:
        dev = kernels.resolve_device(device, "measure_interconnect")
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        if n < 2:
            return InterconnectInfo(num_devices=n)  # provenance "unmeasured"
        mesh = make_mesh(n, dev)
    else:
        mesh = _as_mesh(devices)
    info = InterconnectInfo(num_devices=mesh.size)
    slice_of = slice_of if slice_of is not None else (lambda i: 0)
    slices: dict = {}
    for i in range(mesh.size):
        slices.setdefault(int(slice_of(i)), []).append(i)
    info.num_slices = len(slices)
    if mesh.size < 2:
        return info  # nothing was probed
    info.provenance = "virtual" if mesh.virtual else "measured"
    ici = max(slices.values(), key=len)
    if len(ici) >= 2:
        lat, bw = _collective_times(_sub_mesh(mesh, ici), latency_iters, bandwidth_mb)
        info.ici_allreduce_latency_s = lat
        info.ici_bandwidth = bw
    if info.num_slices > 1:
        lat, bw = _collective_times(_sub_mesh(mesh, [g[0] for g in slices.values()]),
                                    latency_iters, bandwidth_mb)
        info.dcn_latency_s = lat
        info.dcn_bandwidth = bw
    return info


def _sync(mesh: Mesh) -> None:
    for d in dict.fromkeys(mesh.devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _collective_times(mesh: Mesh, latency_iters: int, bandwidth_mb: int):
    """(median small-psum latency s, large-all-gather bytes/s) over the mesh:
    the psum of an (S, 8) float32 (one (1, 8) row a shard) and the
    all_gather of ``bandwidth_mb`` MiB of float32 a shard."""
    n = mesh.size
    tiny = [torch.ones((1, 8), dtype=torch.float32, device=d) for d in mesh.devices]
    out = [torch.empty_like(t) for t in tiny]
    psum = AllReduce(tiny, out, mesh, "sum")
    psum()
    _sync(mesh)
    times = []
    for _ in range(max(1, int(latency_iters))):
        t0 = time.perf_counter()
        psum()
        _sync(mesh)
        times.append(time.perf_counter() - t0)
    latency = sorted(times)[len(times) // 2]
    per_dev = (int(bandwidth_mb) * 1024 * 1024) // 4
    big = [torch.ones(per_dev, dtype=torch.float32, device=d) for d in mesh.devices]
    all_gather(big, mesh)
    _sync(mesh)
    t0 = time.perf_counter()
    all_gather(big, mesh)
    _sync(mesh)
    dt = time.perf_counter() - t0
    # Each shard receives the other n - 1 shards' blocks.
    bandwidth = (n - 1) * per_dev * 4 / dt if dt > 0 else 0.0
    return latency, bandwidth


def estimate_t_comm(
    payload_bytes: int = 1024 * 1024,
    info: Optional[InterconnectInfo] = None,
) -> float:
    """Per-round inter-device time for a payload: latency + payload /
    bandwidth over the slowest link the mesh spans (the cross-island one
    when it spans several); 0.0 on one device. ``info`` defaults to
    :func:`measure_interconnect` on cuda."""
    if info is None:
        info = measure_interconnect()
    if info.num_devices < 2:
        return 0.0
    if info.num_slices > 1 and (info.dcn_latency_s > 0 or info.dcn_bandwidth > 0):
        lat, bw = info.dcn_latency_s, info.dcn_bandwidth or float("inf")
    else:
        lat, bw = info.ici_allreduce_latency_s, info.ici_bandwidth or float("inf")
    return lat + payload_bytes / bw
