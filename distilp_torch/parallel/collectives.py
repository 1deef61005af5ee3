"""Collectives over a :class:`~distilp_torch.parallel.devices.Mesh`: the
port's ``jax.lax.psum``, ``jax.lax.pmax`` and tiled ``jax.lax.all_gather``
inside ``shard_map``.

Each takes one part per shard (shard i's on ``mesh.devices[i]``) and returns
one result per shard, on that shard's device. ``psum`` and ``pmax`` reduce
the parts in shard order (0, 1, ..., S-1), so every shard gets the same bits:
the PDHG's replicated restart decisions depend on it. On CUDA tensors the
parts reach each receiving shard's device by a peer copy (the identity when
shards share a device) and one launch of ``kernels/csrc/collective_kernel.cu``
per receiving shard reduces them; on CPU tensors the plain versions below
compute the same fixed-order reductions. ``all_gather`` is data movement:
the blocks concatenated in mesh order on every shard's device.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from .. import kernels
from .devices import Mesh

_OPS = {"sum": 0, "max": 1}


def _check(parts: Sequence[torch.Tensor], mesh: Mesh) -> None:
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} parts for a mesh of {mesh.size} shards")
    p0 = parts[0]
    for s, p in enumerate(parts):
        if p.dtype != p0.dtype or p.shape != p0.shape:
            raise ValueError(f"part {s}: {p.dtype} {tuple(p.shape)} against part 0's "
                             f"{p0.dtype} {tuple(p0.shape)}")


def psum(parts: Sequence[torch.Tensor], mesh: Mesh,
         out: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """Every shard gets part 0 + part 1 + ... + part S-1 (elementwise)."""
    return _allreduce(parts, mesh, "sum", out)


def pmax(parts: Sequence[torch.Tensor], mesh: Mesh,
         out: Optional[List[torch.Tensor]] = None) -> List[torch.Tensor]:
    """Every shard gets the NaN-propagating elementwise max of the parts."""
    return _allreduce(parts, mesh, "max", out)


def _allreduce(parts, mesh, op, out):
    if out is None:
        out = [torch.empty_like(parts[0], device=d) for d in mesh.devices]
    AllReduce(parts, out, mesh, op)()
    return out


def allreduce_reference(parts: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    """Plain version: the fixed-order reduction of the parts (on part 0's
    device); ``op`` 'sum' or 'max' (NaN-propagating, as the kernel's)."""
    acc = parts[0].clone()
    for p in parts[1:]:
        p = p.to(acc.device)
        if op == "sum":
            acc = acc + p
        else:
            acc = torch.where(torch.isnan(acc) | (acc > p), acc, p)
    return acc


class AllReduce:
    """One exchange, set up once and run many times (the PDHG's per-step
    psum): ``parts[i]`` in, ``out[i]`` (on ``mesh.devices[i]``) out, ``op``
    'sum' or 'max'. On CUDA tensors each call copies the parts that lie on
    another device into staging buffers on the receiving one (peer copies)
    and launches the kernel once per receiving shard; on CPU tensors it runs
    the plain version."""

    def __init__(self, parts: Sequence[torch.Tensor], out: Sequence[torch.Tensor],
                 mesh: Mesh, op: str):
        _check(parts, mesh)
        if len(out) != mesh.size:
            raise ValueError(f"{len(out)} outputs for a mesh of {mesh.size} shards")
        self.parts, self.out, self.op = list(parts), list(out), op
        self.cuda = kernels.on_cuda(*parts, *out)
        if not self.cuda:
            return
        from ..kernels.build import library

        dtype = parts[0].dtype
        if dtype not in (torch.float32, torch.float64):
            raise TypeError(f"collective kernel takes float32 or float64, got {dtype}")
        lib = library("collective")
        self.fn = lib.dtk_allreduce_f64 if dtype == torch.float64 else lib.dtk_allreduce_f32
        self.n = parts[0].numel()
        self.plans = []
        self.multi = len(set(mesh.devices)) > 1
        for s, dev in enumerate(mesh.devices):
            o = out[s]
            if o.device != dev or o.dtype != dtype or o.shape != parts[0].shape \
                    or not o.is_contiguous():
                raise ValueError(f"output {s} must be a contiguous {dtype} "
                                 f"{tuple(parts[0].shape)} tensor on {dev}")
            local, copies = [], []
            for p in parts:
                if p.device == dev and p.is_contiguous():
                    local.append(p)
                else:
                    stage = torch.empty(p.shape, dtype=dtype, device=dev)
                    copies.append((stage, p))
                    local.append(stage)
            ptrs = (ctypes.c_void_p * len(local))(*(t.data_ptr() for t in local))
            self.plans.append((dev, o, local, copies, ptrs, kernels.stream_handle(dev)))

    def __call__(self) -> None:
        if not self.cuda:
            r = allreduce_reference(self.parts, self.op)
            for o in self.out:
                o.copy_(r)
            return
        for dev, o, _local, copies, ptrs, stream in self.plans:
            if self.multi:
                with torch.cuda.device(dev):
                    self._launch(o, copies, ptrs, stream)
            else:
                self._launch(o, copies, ptrs, stream)

    def _launch(self, o, copies, ptrs, stream) -> None:
        for stage, src in copies:
            stage.copy_(src)
        err = self.fn(ptrs, len(ptrs), self.n, _OPS[self.op], kernels.ptr(o), stream)
        kernels.check(err, "collective")
        kernels.count_launch("collective")


def all_gather(blocks: Sequence[torch.Tensor], mesh: Mesh, dim: int = 0) -> List[torch.Tensor]:
    """Every shard gets the blocks concatenated along ``dim`` in mesh order
    (the tiled ``all_gather``)."""
    if len(blocks) != mesh.size:
        raise ValueError(f"{len(blocks)} blocks for a mesh of {mesh.size} shards")
    return [torch.cat([b.to(dev) for b in blocks], dim) for dev in mesh.devices]
