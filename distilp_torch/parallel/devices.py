"""Device meshes of the port: the mesh parts of
``distilp_tpu/utils/shardcompat.py`` (``shard_mesh``, ``force_host_devices``).

A :class:`Mesh` is S shards, each on a device of one type. The port is a
single controller, as the JAX package's ``shard_map`` programs are: one
process holds every shard and sequences the collectives between them
(:mod:`distilp_torch.parallel.collectives`).

:func:`shard_mesh` resolves S shards to the first S visible devices of the
caller's device type (cuda, or cpu, which counts as one device). With fewer
devices it raises, unless the process declared a *virtual* mesh of at least S
devices (:func:`force_virtual_devices`, the counterpart of the JAX package's
forced host-device count): then shard i runs on device i mod count, several
shards share a device, and the mesh is marked virtual. Every shard's kernels
and collectives then run on that device and can be held against the
unsharded engine. A mesh over distinct GPUs takes the same code.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Tuple

import torch

# The environment variable that declares a virtual mesh of that many devices
# (read when a mesh is resolved, so it may be set any time before).
VIRTUAL_DEVICES_ENV = "DISTILP_TORCH_VIRTUAL_DEVICES"


class Mesh(NamedTuple):
    """S shards, shard i on ``devices[i]``. ``virtual``: several shards share
    a device (or the devices are the CPU), so the collectives move no bytes
    across a link."""

    devices: Tuple[torch.device, ...]
    virtual: bool

    @property
    def size(self) -> int:
        return len(self.devices)


def virtual_device_count() -> int:
    """The virtual mesh size this process declared (0: none)."""
    try:
        return max(0, int(os.environ.get(VIRTUAL_DEVICES_ENV, "0") or 0))
    except ValueError:
        return 0


def force_virtual_devices(n: int) -> bool:
    """Declare a virtual mesh of ``n`` devices unless one is declared
    already; True when the environment was changed."""
    if virtual_device_count() > 0:
        return False
    os.environ[VIRTUAL_DEVICES_ENV] = str(int(n))
    return True


def _visible(kind: str) -> int:
    if kind == "cuda":
        return torch.cuda.device_count()
    return 1


def shard_mesh(n_shards: int, device=None) -> Mesh:
    """A 1-D mesh of ``n_shards`` shards on devices of ``device``'s type
    (None = cuda). Raises when fewer devices are visible and no virtual mesh
    of at least ``n_shards`` was declared."""
    if int(n_shards) < 1:
        raise ValueError(f"mesh_shards must be >= 1 (got {n_shards})")
    n_shards = int(n_shards)
    kind = torch.device("cuda" if device is None else device).type
    count = _visible(kind)
    if count < 1:
        raise ValueError(f"mesh_shards={n_shards} but no {kind} device is visible")
    if n_shards <= count and kind == "cuda":
        return Mesh(tuple(torch.device("cuda", i) for i in range(n_shards)), False)
    if n_shards == 1:
        return Mesh((torch.device(kind),), kind == "cpu")
    declared = virtual_device_count()
    if declared < n_shards:
        raise ValueError(
            f"mesh_shards={n_shards} but only {count} {kind} device(s) visible; "
            f"declare a virtual mesh with {VIRTUAL_DEVICES_ENV}={n_shards} (or "
            f"more), see {__name__}.force_virtual_devices"
        )
    if kind == "cuda":
        devs = tuple(torch.device("cuda", i % count) for i in range(n_shards))
    else:
        devs = (torch.device(kind),) * n_shards
    return Mesh(devs, True)


def make_mesh(n_devices=None, device=None) -> Mesh:
    """``distilp_tpu/parallel/mesh.py::make_mesh``: a mesh over the first
    ``n_devices`` devices (None = every visible one) of ``device``'s type."""
    if n_devices is None:
        n_devices = _visible(torch.device("cuda" if device is None else device).type)
    return shard_mesh(n_devices, device)
