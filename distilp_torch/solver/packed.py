"""A sweep's two halves on the card, and its answer as one vector.

The reference ships a sweep to the TPU as a static blob that stays on the
device across ticks, content-addressed (``distilp_tpu/solver/backend_jax.py
::_static_to_device`` :2046, ``_STATIC_CACHE`` :2028), and a per-tick
dynamic blob (``_pack_dynamic`` :1928), and reads the answer back as one
float64 vector (``_solve_packed_impl``). Here:

- :func:`static_entry`: the float32 A of a sweep (or each lane's), its
  sparse structure (``search.node_sparsity``, built and checked once per
  entry, never per solve) and K1's values on it, cached by the bytes of
  ``backend_torch.pack_static`` (an LRU of :data:`STATIC_CAP` entries under
  a lock). On a hit nothing of A is uploaded or rebuilt.
- :class:`DynLayout`: everything drift can touch (b, the boxes with their
  cycle-time box, the objective, the integer mask, k and W, ``obj_const``,
  the rounding data in ``pack_rounding_data``'s (17, M) float64 order, the
  MoE expert-busy table, the warm hint, a previous solve's root iterates,
  the margin bounds, the stored multipliers) in one byte buffer, each field at an aligned offset:
  packed on the host (:func:`pack_dynamic`), sent in one host-to-device
  copy, and read on the card through typed views (:func:`dyn_views`).
  float64 stays float64.
- :class:`AnswerLayout`: one float64 row a lane, in ``_solve_packed_impl``'s
  order (the head, the incumbent's assignment, each k's best, the duals and
  raw root bounds, the per-k block, the root round's iterates, then the
  margin anchor and the round log where asked), read back with one
  device-to-host copy into pinned memory and split by :func:`split_answer`.

:data:`COPIES` counts the host-to-device and device-to-host copies these
make (the static upload of a miss, the dynamic blob, the answer).
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.ipm import IPMSparsity, check_sparsity
from .rounding import KERNEL_RD_FIELDS, MOE_RD_FIELDS, PACKED_ROWS, RoundingData

# Static entries kept on the card (the reference keeps 4).
STATIC_CAP = 4
# Byte alignment of every field of the dynamic blob.
ALIGN = 128

# Copies between host and card made by the packed halves and the answer.
COPIES: Dict[str, int] = {"h2d": 0, "d2h": 0}
# Static entries built (A uploaded or taken, structure built and checked)
# and hits.
STATIC_STATS: Dict[str, int] = {"builds": 0, "hits": 0}


def reset_counts() -> None:
    for d in (COPIES, STATIC_STATS):
        for k in d:
            d[k] = 0


class StaticEntry:
    """A sweep's A on the card with its structure and K1's values on it.
    ``A`` is (m, nf), or (L, m, nf) for lanes with an A each (the structure
    then their union); ``values`` (nnz,) or (L, nnz). The PDHG's values
    (``search.sweep_values``) are made on first use and kept."""

    __slots__ = ("key", "A", "sparsity", "values", "M", "moe", "_pdhg", "_mesh")

    def __init__(self, key, A: torch.Tensor, sparsity: IPMSparsity, M: int, moe: bool):
        self.key = key
        self.A = A
        self.sparsity = sparsity
        m, n = sparsity.m, sparsity.n
        self.values = A.reshape(*A.shape[:-2], m * n)[..., sparsity.src].contiguous()
        self.M = M
        self.moe = moe
        self._pdhg = None
        self._mesh = {}

    def pdhg_values(self):
        """(A_values, gky_pos) of :class:`~.search.SweepData` for K5."""
        from .search import sweep_values

        if self._pdhg is None:
            self._pdhg = sweep_values(self.A, self.sparsity, self.M, self.moe)
        return self._pdhg

    @property
    def per_element(self) -> bool:
        """An A per element: MoE nodes, or lanes with an A each."""
        return self.moe or (self.A.dim() == 3 and self.A.shape[0] > 1)

    def mesh_blocks(self, shards: int, dtype=None):
        """K6b's row blocks of this entry on a row mesh of ``shards``, made on
        first use and kept: a per-element A's (MoE nodes) structure split by
        block (``ops.meshlp.row_blocks``), or the one shared A's dense blocks
        and their transposes in ``dtype`` (``ops.meshlp.dense_blocks``)."""
        from ..ops.meshlp import dense_blocks, row_blocks

        key = (int(shards), None if self.per_element else dtype)
        got = self._mesh.get(key)
        if got is None:
            got = self._mesh[key] = (
                row_blocks(self.sparsity, shards) if self.per_element
                else dense_blocks(self.A if self.A.dim() == 2 else self.A[0], shards, dtype))
        return got


_STATIC: "OrderedDict[tuple, StaticEntry]" = OrderedDict()
_STATIC_LOCK = threading.Lock()


def static_entry(key, A, M: int, moe: bool, device) -> Tuple[StaticEntry, bool]:
    """(entry, hit) of the sweep whose static half is ``key`` (bytes, or a
    tuple of each lane's). ``A`` is the host float32 matrix (uploaded on a
    miss), a tensor already on ``device``, or a function that makes one,
    called only on a miss (a hit then runs nothing on the card)."""
    from .search import node_sparsity

    dev = torch.device(device)
    full = (str(dev), int(M), bool(moe), key)
    with _STATIC_LOCK:
        hit = _STATIC.get(full)
        if hit is not None:
            _STATIC.move_to_end(full)
            STATIC_STATS["hits"] += 1
            return hit, True
    if callable(A):
        A = A()
    if isinstance(A, torch.Tensor):
        A_dev = A.to(dev)
    else:
        A_dev = torch.as_tensor(np.ascontiguousarray(A, np.float32), device=dev)
        if dev.type == "cuda":
            COPIES["h2d"] += 1
    sparsity = node_sparsity(A_dev, M, moe)
    check_sparsity(A_dev, sparsity)
    entry = StaticEntry(full, A_dev, sparsity, M, moe)
    with _STATIC_LOCK:
        _STATIC[full] = entry
        while len(_STATIC) > STATIC_CAP:
            _STATIC.popitem(last=False)
        STATIC_STATS["builds"] += 1
    return entry, False


def clear_static_cache() -> None:
    """Drop the cached static entries (tests; device teardown)."""
    with _STATIC_LOCK:
        _STATIC.clear()


def static_cache_size() -> int:
    with _STATIC_LOCK:
        return len(_STATIC)


# ------------------------------------------------------------ dynamic half


class DynLayout(NamedTuple):
    """Each field's (dtype, shape, byte offset) in the dynamic blob."""

    fields: Dict[str, Tuple[torch.dtype, tuple, int]]
    nbytes: int


def dyn_layout(L: int, n_k: int, m: int, nf: int, M: int, moe: bool, has_warm: bool,
               has_root_warm: bool, has_margin: bool, has_duals: bool = False) -> DynLayout:
    """The dynamic blob's fields; ``has_duals``: a MoE sweep's stored
    multipliers (lam, mu, tau per lane, float64), which the loop's graph
    reads (the host route takes them as a separate tensor)."""
    f32, f64, b = torch.float32, torch.float64, torch.bool
    spec: List[Tuple[str, torch.dtype, tuple]] = [
        ("b_k", f32, (L, n_k, m)), ("c_k", f32, (L, n_k, nf)), ("lo_k", f32, (L, n_k, nf)),
        ("hi_k", f32, (L, n_k, nf)), ("int_mask", b, (L, nf)), ("ks", f64, (L, n_k)),
        ("Ws", f64, (L, n_k)), ("obj_const", f64, (L,)), ("rd", f64, (L, PACKED_ROWS, M)),
        ("rd_scalars", f64, (L, 2)),
    ]
    if moe:
        spec.append(("gky", f32, (L, n_k, 2, M)))
    if has_warm:
        spec += [("warm_kidx", torch.int64, (L,)), ("warm_w", f64, (L, M)),
                 ("warm_n", f64, (L, M)), ("warm_y", f64, (L, M))]
    if has_root_warm:
        spec += [("rw_ok", b, (L, n_k)), ("rw_v", f32, (L, n_k, nf)), ("rw_y", f32, (L, n_k, m)),
                 ("rw_z", f32, (L, n_k, nf)), ("rw_f", f32, (L, n_k, nf))]
    if has_margin:
        spec.append(("margin", f64, (L, n_k)))
    if has_duals:
        spec.append(("duals", f64, (L, n_k * (2 + M))))
    fields, pos = {}, 0
    for name, dt, shape in spec:
        fields[name] = (dt, shape, pos)
        size = torch.empty((), dtype=dt).element_size() * math.prod(shape)
        pos += -(-size // ALIGN) * ALIGN
    return DynLayout(fields, pos)


_NP = {torch.float32: np.float32, torch.float64: np.float64, torch.bool: np.bool_,
       torch.int64: np.int64}


def pack_dynamic(lanes, layout: DynLayout, buf: np.ndarray) -> None:
    """Write the dynamic half of ``lanes`` (``backend_torch.LaneInput``s)
    into ``buf`` (uint8, ``layout.nbytes``), field by field."""

    def put(name, value):
        dt, shape, off = layout.fields[name]
        size = np.dtype(_NP[dt]).itemsize * math.prod(shape)
        buf[off : off + size].view(_NP[dt]).reshape(shape)[...] = value

    f = layout.fields
    put("b_k", [ln.host["b_k"] for ln in lanes])
    put("c_k", [ln.host["c_k"] for ln in lanes])
    put("lo_k", [ln.host["lo_k"] for ln in lanes])
    put("hi_k", [ln.host["hi_k"] for ln in lanes])
    put("int_mask", [ln.host["int_mask"] for ln in lanes])
    put("ks", [np.asarray(ln.sf.ks, np.float64) for ln in lanes])
    put("Ws", [np.asarray(ln.sf.Ws, np.float64) for ln in lanes])
    put("obj_const", [float(ln.sf.obj_const) for ln in lanes])
    dt, shape, off = f["rd"]
    rd = buf[off : off + 8 * math.prod(shape)].view(np.float64).reshape(shape)
    for q, ln in enumerate(lanes):
        r = ln.rd_np  # a scalar field is broadcast over its row
        for i, name in enumerate(KERNEL_RD_FIELDS):
            rd[q, i] = r[name]
        rd[q, len(KERNEL_RD_FIELDS)] = float(r["bprime"])
        for i, name in enumerate(MOE_RD_FIELDS):
            rd[q, len(KERNEL_RD_FIELDS) + 1 + i] = r[name]
    put("rd_scalars", [[float(ln.rd_np["bprime"]), float(ln.rd_np["E"])] for ln in lanes])
    if "gky" in f:
        put("gky", [ln.host["gky"] for ln in lanes])
    if "warm_kidx" in f:
        put("warm_kidx", [int(ln.warm_tuple[0]) for ln in lanes])
        for i, name in ((1, "warm_w"), (2, "warm_n"), (3, "warm_y")):
            put(name, [np.asarray(ln.warm_tuple[i], np.float64) for ln in lanes])
    if "rw_ok" in f:
        put("rw_ok", [np.asarray(ln.root_warm_tuple[0], np.float32) > 0.5 for ln in lanes])
        for i, name in ((1, "rw_v"), (2, "rw_y"), (3, "rw_z"), (4, "rw_f")):
            put(name, [ln.root_warm_tuple[i] for ln in lanes])
    if "margin" in f:
        put("margin", [ln.margin_np for ln in lanes])
    if "duals" in f:
        put("duals", [np.concatenate([np.ravel(x) for x in ln.duals_tuple]) for ln in lanes])


def dyn_views(buf: torch.Tensor, layout: DynLayout) -> Dict[str, torch.Tensor]:
    """The typed views of a dynamic blob (on the card or the host)."""
    out = {}
    for name, (dt, shape, off) in layout.fields.items():
        size = torch.empty((), dtype=dt).element_size() * math.prod(shape)
        out[name] = buf[off : off + size].view(dt).view(shape)
    return out


def rounding_views(views: Dict[str, torch.Tensor]) -> RoundingData:
    """The lanes' :class:`RoundingData` as views of the packed rows (vectors
    (L, M), ``bprime`` and ``E`` (L,))."""
    rd = views["rd"]
    rows = {name: rd[:, i] for i, name in enumerate(KERNEL_RD_FIELDS)}
    base = len(KERNEL_RD_FIELDS) + 1
    rows.update({name: rd[:, base + i] for i, name in enumerate(MOE_RD_FIELDS)})
    sc = views["rd_scalars"]
    return RoundingData(**rows, bprime=sc[:, 0], E=sc[:, 1])


# --------------------------------------------------------------- pinned host

_PINNED: Dict[int, List[torch.Tensor]] = {}
_PINNED_LOCK = threading.Lock()


def take_pinned(nbytes: int, device) -> torch.Tensor:
    """A uint8 host buffer of ``nbytes``: pinned, from a pool, for a CUDA
    ``device``; a fresh one for the CPU."""
    if torch.device(device).type != "cuda":
        return torch.empty(nbytes, dtype=torch.uint8)
    with _PINNED_LOCK:
        free = _PINNED.get(nbytes)
        if free:
            return free.pop()
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def give_pinned(buf: Optional[torch.Tensor]) -> None:
    """Return a buffer of :func:`take_pinned` once no copy uses it."""
    if buf is None or not buf.is_pinned():
        return
    with _PINNED_LOCK:
        free = _PINNED.setdefault(buf.numel(), [])
        if len(free) < 8:
            free.append(buf)


def upload(host: torch.Tensor, device, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The dynamic blob on ``device``: one host-to-device copy (into ``out``
    when given); on the CPU the host buffer itself."""
    if torch.device(device).type != "cuda":
        if out is None:
            return host
        out.copy_(host)
        return out
    if out is None:
        out = torch.empty(host.numel(), dtype=torch.uint8, device=device)
    out.copy_(host, non_blocking=True)
    COPIES["h2d"] += 1
    return out


# ------------------------------------------------------------------ answer


class AnswerLayout(NamedTuple):
    """One lane's answer row: ``head`` columns first (what
    ``backend_torch._decode_sweep`` reads as the head), then the root
    round's iterates (ok (n_k,), v (n_k, nf), y (n_k, m), z, f), then the
    margin anchor ``m_y`` and the round log, where asked."""

    M: int
    n_k: int
    m: int
    nf: int
    has_duals: bool
    per_k: bool
    my_shape: tuple = ()  # (n_k, M, E + 1) of the margin anchor
    conv_rows: int = 0
    trace_shape: tuple = ()  # (n_k, trace rows, TRACE_COLS) of the root LP trace

    @property
    def my_size(self) -> int:
        return math.prod(self.my_shape) if self.my_shape else 0

    @property
    def trace_size(self) -> int:
        return math.prod(self.trace_shape) if self.trace_shape else 0

    @property
    def head(self) -> int:
        n = 5 + 3 * self.M + self.n_k
        if self.has_duals:
            n += 3 * self.n_k + self.n_k * self.M
        if self.per_k:
            n += 3 * self.n_k * self.M + self.n_k
        return n

    @property
    def root_sizes(self) -> Tuple[int, ...]:
        k = self.n_k
        return (k, k * self.nf, k * self.m, k * self.nf, k * self.nf)

    @property
    def width(self) -> int:
        from .search import RL_COLS

        return (self.head + sum(self.root_sizes) + self.my_size + self.conv_rows * RL_COLS
                + self.trace_size)


def split_answer(ans: np.ndarray, lay: AnswerLayout) -> dict:
    """``_search``'s read-back dict from the (L, width) answer: ``head``,
    ``root`` (ok, v, y, z, f per lane), ``m_y`` and ``conv``."""
    from .search import RL_COLS

    L = ans.shape[0]
    o = lay.head
    out = {"head": ans[:, :o]}
    shapes = ((lay.n_k,), (lay.n_k, lay.nf), (lay.n_k, lay.m), (lay.n_k, lay.nf),
              (lay.n_k, lay.nf))
    root = []
    for size, shape in zip(lay.root_sizes, shapes):
        root.append(ans[:, o : o + size].reshape(L, *shape))
        o += size
    out["root"] = root
    out["m_y"] = None
    if lay.my_size:
        out["m_y"] = ans[:, o : o + lay.my_size].reshape(L, *lay.my_shape)
        o += lay.my_size
    out["conv"] = None
    if lay.trace_shape:
        rl = ans[:, o : o + lay.conv_rows * RL_COLS].reshape(L, lay.conv_rows, RL_COLS)
        o += lay.conv_rows * RL_COLS
        out["conv"] = (np.ascontiguousarray(rl.transpose(1, 0, 2)),
                       ans[:, o : o + lay.trace_size].reshape(L, *lay.trace_shape))
    return out


def read_answer(ans: torch.Tensor) -> np.ndarray:
    """The (L, width) float64 answer on the host: one device-to-host copy
    into pinned memory, then a synchronize of the stream it was made on."""
    if ans.device.type != "cuda":
        return ans.numpy().copy()
    host = take_pinned(ans.numel() * 8, ans.device)
    view = host.view(torch.float64).view(ans.shape)
    view.copy_(ans, non_blocking=True)
    COPIES["d2h"] += 1
    torch.cuda.current_stream(ans.device).synchronize()
    out = view.numpy().copy()
    give_pinned(host)
    return out
