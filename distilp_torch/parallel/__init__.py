"""The port's device meshes, their collectives and the node-sharded sweep
(``distilp_tpu/parallel`` and the mesh parts of ``utils/shardcompat.py``)."""

from .devices import (
    VIRTUAL_DEVICES_ENV,
    Mesh,
    force_virtual_devices,
    make_mesh,
    shard_mesh,
    virtual_device_count,
)
from .mesh import NODE_AXIS, pad_cap_to_mesh, solve_sweep_sharded

__all__ = [
    "NODE_AXIS",
    "VIRTUAL_DEVICES_ENV",
    "Mesh",
    "force_virtual_devices",
    "make_mesh",
    "pad_cap_to_mesh",
    "shard_mesh",
    "solve_sweep_sharded",
    "virtual_device_count",
]
