"""Carry arrays from the JAX package's solver into the port's tensors.

:func:`from_jax_arrays` takes what the reference produces, as numpy arrays
or anything ``np.asarray`` reads, and builds the port's counterpart with the
same field names and dtypes: an ``LPBatch``/``IPMWarmState``/``IPMResult``,
a ``RoundingData``, a ``SearchState``, or the ``ipm_state`` dict of a
``HALDAResult`` (returned as numpy, which is how both packages carry it).
So a test can feed one input to both packages, and a warm result from one
package can seed the other. :func:`scheduler_state_from_jax` carries a
whole scheduler's state (fleet, published placement, breaker, warm pool,
speculation bank) across, and :func:`gateway_snapshot_from_jax` a whole
gateway's, shard by shard. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .ops.ipm import IPMResult, IPMWarmState, LPBatch
from .solver.rounding import RoundingData
from .solver.search import SearchState

_TYPES = {
    cls.__name__: cls
    for cls in (LPBatch, IPMWarmState, IPMResult, RoundingData, SearchState)
}
IPM_STATE_KEYS = ("ok", "v", "y", "z", "f")


def to_tensor(a: Any, device="cpu") -> torch.Tensor:
    """One array as a tensor with the same dtype (bool, int32, float32,
    float64 ...) and shape."""
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def from_jax_arrays(obj: Any, device="cpu", kind: str = None):
    """The port's counterpart of a JAX-package container.

    ``obj`` is a NamedTuple of the JAX package (matched by class name, or
    by ``kind``), a mapping of field name to array for one of those kinds,
    or an ``ipm_state`` dict (keys ok/v/y/z/f). A field that is None (an
    untraced result's trace buffer) stays None.
    """
    if isinstance(obj, dict) and kind is None and set(obj) == set(IPM_STATE_KEYS):
        return {
            "ok": np.asarray(obj["ok"]) > 0.5,
            **{k: np.asarray(obj[k], np.float64) for k in IPM_STATE_KEYS[1:]},
        }
    name = kind or type(obj).__name__
    if name not in _TYPES:
        raise TypeError(f"no port counterpart for {name!r}")
    cls = _TYPES[name]
    fields = obj if isinstance(obj, dict) else obj._asdict()
    return cls(**{f: None if fields.get(f) is None else to_tensor(fields[f], device)
                  for f in cls._fields})


def _warm_blob_from_jax(blob: dict) -> dict:
    """A replanner's warm-state blob with its root iterates in the port's
    dtypes (``ok`` bool, the rest float64); the other fields are the same
    wire format in both packages."""
    from .solver.streaming import WARM_BLOB_VERSION, _decode_state, _encode_state

    if blob.get("version") != WARM_BLOB_VERSION:
        raise ValueError(f"unknown warm-state blob version {blob.get('version')!r}")
    out = dict(blob)
    out["ipm_state"] = _encode_state(_ipm_state_from_jax(_decode_state(blob.get("ipm_state"))))
    return out


def _ipm_state_from_jax(state):
    if isinstance(state, dict) and set(state) == set(IPM_STATE_KEYS):
        return from_jax_arrays(state)
    return state


def scheduler_state_from_jax(state: dict) -> dict:
    """The port's ``Scheduler.load_state`` blob from a JAX-package
    ``Scheduler.dump_state()`` blob (version 1).

    The fleet, the model and every placement are validated against the
    port's schemas (the same fields as the reference's); each pooled
    replanner's warm blob and each speculation-bank entry keeps its
    incumbent, duals and margin anchor bit for bit, with the root LP
    iterates in the port's dtypes. So a trace started under the reference
    finishes under the port with warm ticks: ``load_state`` of the result
    counts the first tick under ``warm_resumes``.
    """
    from .common import DeviceProfile, ModelProfile
    from .solver.result import HALDAResult
    from .solver.streaming import _decode_state, _encode_state

    if state.get("version") != 1:
        raise ValueError(f"unknown scheduler state version {state.get('version')!r}")
    out = dict(state)
    out["devices"] = [DeviceProfile.model_validate(d).model_dump() for d in state["devices"]]
    out["model"] = ModelProfile.model_validate(state["model"]).model_dump()
    if state.get("published") is not None:
        pub = dict(state["published"])
        pub["result"] = HALDAResult.model_validate(pub["result"]).model_dump()
        out["published"] = pub
    out["pool"] = [{"key": list(e["key"]), "warm": _warm_blob_from_jax(e["warm"])}
                   for e in state["pool"]]
    spec = state.get("spec")
    if spec and spec.get("bank"):
        bank = dict(spec["bank"])
        bank["entries"] = [
            {**e, "result": HALDAResult.model_validate(e["result"]).model_dump(),
             "ipm_state": _encode_state(_ipm_state_from_jax(_decode_state(e.get("ipm_state"))))}
            for e in bank.get("entries", [])
        ]
        out["spec"] = {**spec, "bank": bank}
    return out


def gateway_snapshot_from_jax(snap):
    """The port's ``GatewaySnapshot`` from a JAX-package gateway snapshot:
    its JSON text, the parsed dict, or anything with ``model_dump()``.

    Each shard keeps its fleet id, model id, shard key and resume cursor;
    its scheduler state goes through :func:`scheduler_state_from_jax`, so
    the port's ``Gateway.load_snapshot`` restores every shard warm and the
    next tick of each counts under ``warm_resumes``."""
    import json

    from .gateway.snapshot import SNAPSHOT_VERSION, GatewaySnapshot

    if isinstance(snap, (str, bytes)):
        snap = json.loads(snap)
    elif hasattr(snap, "model_dump"):
        snap = snap.model_dump()
    if snap.get("version") != SNAPSHOT_VERSION:
        raise ValueError(f"unknown gateway snapshot version {snap.get('version')!r}")
    shards = [{**sh, "state": scheduler_state_from_jax(sh["state"])}
              for sh in snap.get("shards", [])]
    return GatewaySnapshot.model_validate({**snap, "shards": shards})
