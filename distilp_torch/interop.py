"""Carry arrays from the JAX package's solver into the port's tensors.

:func:`from_jax_arrays` takes what the reference produces, as numpy arrays
or anything ``np.asarray`` reads, and builds the port's counterpart with the
same field names and dtypes: an ``LPBatch``/``IPMWarmState``/``IPMResult``,
a ``RoundingData``, a ``SearchState``, or the ``ipm_state`` dict of a
``HALDAResult`` (returned as numpy, which is how both packages carry it).
So a test can feed one input to both packages, and a warm result from one
package can seed the other. Nothing here imports JAX.
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
    or an ``ipm_state`` dict (keys ok/v/y/z/f). Fields the port's type does
    not have (the reference's trace buffers) are dropped.
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
    return cls(**{f: to_tensor(fields[f], device) for f in cls._fields})
