"""The branch-and-bound of a sweep as one CUDA graph.

The reference runs a sweep as one device program (``distilp_tpu/solver/
backend_jax.py::_solve_packed_impl`` :2100 with ``_run_bnb_loop`` :2732):
the root state, for a MoE sweep the root bounds and the Lagrangian-primal
incumbents, the warm incumbent, the root round, a ``lax.while_loop`` whose
condition, the gap test, runs on the device, and the answer. Here a
:class:`LoopPlan` owns every buffer of a solve of one signature (shapes,
budgets, ``mip_gap``, ``max_rounds``, which optional inputs it has, the
MoE seed's mode) and, on the card, one CUDA graph over them, captured once
(``bnb_loop_kernel.cu``):

    seed [MoE: K7, its folds, the MoE seed around K2 MoE] -> init
         -> root round (state A -> B)
         -> WHILE { round B -> A, round A -> B } -> answer

a round being the head (the LP's inputs straight from the state; a MoE
row's per-node A), the LP engine on the plan's buffers (K1, or K5 on the
route the signature fixed, then for ``pdhg_dtype='f64'`` the cast of its
result to the search's float32), (MoE) K2 MoE's LP rows, the round tail
into the other state buffer, and the loop's control, which sets the WHILE
node's condition from the device. A diagnostics plan (``diag``: the
reference's ``_solve_packed_impl(diag=True)`` with ``_run_bnb_loop(
collect_rounds=True)``, :2125, :2777) is the same graph with a log threaded
through it: the root round's LP runs with its convergence trace on (B13,
into a buffer the plan owns; its other outputs are the untraced launch's
bit for bit), the control writes each round's row of the round log on the
card (``search.round_row``), and the answer carries the log and the trace,
so ``halda_solve(convergence=...)`` is one upload, one graph launch and one
read like the solve it describes. The meshes of one card have round shapes
of their own:

    row mesh   head (its mesh mode: b and the warm y into the S row blocks,
               a MoE row's values into its blocks) -> K6b's fused launch a
               slice of BMAX rows -> the gather of the dual blocks -> (f64)
               the cast -> (MoE) K2 MoE -> the round tail -> control
    node mesh  head -> for each shard s, its L*B/S rows: K1 or K5 at that
               row offset -> (f64) the cast -> for each shard, K2's dense
               entry or MoE mode on its rows -> the round tail (rows
               pre-rounded) -> control

(``search._node_sharded``'s shard-by-shard batches, so both routes agree
bit for bit). A solve is then one upload of the dynamic blob (``packed``),
one graph launch and one read of the answer. On CPU tensors the same plan
runs the plain versions (``search.root_state``/``seed_root_bounds``/
``seed_warm``, ``search.round_inputs``, the head's MoE and mesh modes, K1's,
K5's or ``ops.meshlp.sharded_pdhg_reference``, the gather's, K2's and the
round tail's plain versions, :func:`control_reference`,
:func:`answer_reference`), a Python ``while`` standing in for the
conditional node.

The route is chosen by the configuration (:func:`loop_route`): the graph
for dense and MoE sweeps on either engine, whatever the lanes (one A or an
A each), per-k or not, on the PDHG whatever its dtype and K5's route, and
on a row or node mesh whose shards all lie on the search's card, with the
round log or without; only a mesh over distinct cards keeps
``search.run_bnb_loop``, the host loop.
``kernels.SHAPES["bnb_graph"]`` counts the route of every search. A failed
capture, instantiation or launch raises: nothing falls back to the host
loop, which stays only as the private :func:`host_loop` for the card's
comparison.
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
import time
from collections import OrderedDict
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..obs import compile_ledger as _compile_ledger
from ..obs import memory as _memory
from ..ops.ipm import (
    IPM_DEFAULT_CHUNK,
    TRACE_COLS,
    THREADS as IPM_THREADS,
    IPMResult,
    LPBatch,
    _default_reg,
    _default_tol,
    chunking,
    ipm_solve_batch,
    ipm_workspace,
)
from ..ops.decomp import RD_DEV_FIELDS, DecompBatch
from ..ops import meshlp as _meshlp
from ..ops import pdhg as _pdhg
from ..ops.pdhg import (
    DEFAULT_RESTART_TOL,
    PDHG_DEFAULT_CHUNK,
    ElemA,
    _default_tol_pdhg,
    k5_launch,
    k5_name,
    k5_shape,
)
from . import packed
from . import search as _search
from .rounding import (
    KERNEL_RD_FIELDS,
    MOE_RD_FIELDS,
    MOE_THREADS,
    PACKED_ROWS,
    moe_table_workspace,
)
from .search import (
    BDTYPE,
    DTYPE,
    RL_COLS,
    TAIL_SMEM_LIMIT,
    SearchState,
    SweepData,
    _lanes_of,
    best_bound,
    cast_lp_result,
    certified,
    certified_per_k,
    per_k_bound,
    root_state,
    round_inputs,
    round_row,
    round_rows,
    round_tail,
    seed_root_bounds,
    seed_warm,
    tail_layout,
    tail_views,
)
from .standard_form import MOE_LOCAL_MOVES, MOE_LOCAL_MOVES_WARM

# The packed rounding data's row of each field (rounding.pack_rounding_data:
# the dense vectors, b', then the MoE vectors), and the most rows of K7's
# problem the seed's dims carry.
_RD_ROWS = {**{f: i for i, f in enumerate(KERNEL_RD_FIELDS)}, "bprime": len(KERNEL_RD_FIELDS),
            **{f: len(KERNEL_RD_FIELDS) + 1 + i for i, f in enumerate(MOE_RD_FIELDS)}}
_DEV_ROWS = 16

_PRIVATE = threading.local()


@contextlib.contextmanager
def host_loop():
    """Solves prepared on this thread inside the block take the host loop
    (``search.run_bnb_loop``) whatever their route: the card's comparison
    of the two routes, not a user setting."""
    prev = getattr(_PRIVATE, "host", False)
    _PRIVATE.host = True
    try:
        yield
    finally:
        _PRIVATE.host = prev


def forced_host_loop() -> bool:
    return getattr(_PRIVATE, "host", False)


def loop_route(moe: bool, engine: str, row_mesh, collect_rounds: bool, node_mesh=None,
               device=None) -> Tuple[str, str]:
    """("graph" | "host", why) of a search's configuration: the graph for
    dense and MoE sweeps on the IPM and the PDHG engine, and for a row mesh
    (``row_mesh``, more than one shard; the PDHG's) or a node mesh
    (``node_mesh``) whose shards all lie on the search's ``device``; a mesh
    over distinct cards (until a transport joins their graphs) keeps the
    host loop. The round log (``collect_rounds``) takes the route of its
    configuration untraced, its why marked ``+log``; a node mesh takes
    none (``parallel.solve_sweep_sharded`` has no round log)."""
    if collect_rounds and node_mesh is not None:
        raise ValueError("a node-mesh sweep takes no round log")
    log = "+log" if collect_rounds else ""
    moe_ = "moe_" if moe else ""
    # A row mesh partitions the PDHG's rows (the IPM engine refuses one).
    if row_mesh is not None and row_mesh.size > 1 and engine == "pdhg":
        if not _one_card(row_mesh, device):
            return "host", "row_mesh_cards" + log
        return "graph", f"{moe_}row_mesh_{engine}{log}"
    if node_mesh is not None:
        if not _one_card(node_mesh, device):
            return "host", "node_mesh_cards"
        return "graph", f"{moe_}node_mesh_{engine}"
    return "graph", f"{'moe' if moe else 'dense'}_{engine}{log}"


def _one_card(mesh, device) -> bool:
    """Every shard of ``mesh`` on the search's device (a virtual mesh of one
    card, or of the CPU)."""
    dev = torch.device(mesh.devices[0] if device is None else device)

    def index(d):
        d = torch.device(d)
        if d.type != "cuda" or d.index is not None:
            return d.index
        return torch.cuda.current_device()

    return all(torch.device(d).type == dev.type and index(d) == index(dev)
               for d in mesh.devices)


def note_route(route: str, why: str, L: int) -> None:
    """One search of ``route`` in ``kernels.SHAPES['bnb_graph']``."""
    key = f"route={route} {why} L={L}"
    shapes = kernels.SHAPES["bnb_graph"]
    shapes[key] = shapes.get(key, 0) + 1


class PlanSig(NamedTuple):
    """What a plan's buffers and graph are built for."""

    device: str
    L: int
    cap: int
    B0: int  # root round rows a lane (n_k)
    Bw: int  # warm round rows a lane (the beam)
    m: int
    nf: int
    M: int
    n_k: int
    per_k: bool
    ipm_iters: int
    root_chunk: int
    warm_iters: int
    mip_gap: float
    max_rounds: int
    has_warm: bool
    has_root_warm: bool
    a_lanes: bool  # an A a lane (K1's per-node route)
    nnz: int
    nent: int
    ncontrib: int
    index_len: int
    # MoE sweeps: K7's lattice (w_max, e_max), its ascent steps (300 cold,
    # 0 on a warm tick), whether the upload carries stored duals and margin
    # bounds (a margin tick: no K7), and whether the answer carries m_y.
    moe: bool = False
    w_max: int = 0
    e_max: int = 0
    decomp_steps: int = 0
    has_duals: bool = False
    has_margin: bool = False
    want_my: bool = False
    # The LP engine ("ipm" | "pdhg"; the iteration budgets above are the
    # engine's), and on the PDHG its iterate dtype (float64 for
    # pdhg_dtype='f64'), its restart factor and K5's route: "cluster" with
    # its cluster size C, the ownership plan's shared-memory bytes and
    # buffer length (the plan depends on A's pattern, not only on nnz), or
    # "grid".
    engine: str = "ipm"
    lp_f64: bool = False
    restart_tol: float = 0.0
    route: str = ""
    C: int = 0
    smem: int = 0
    buf_len: int = 0
    # A mesh of one card: "row" (K6b: A's rows over S shards, ms padded rows
    # a shard, Gs of the card's blocks a shard's group in a fused launch (0
    # on the CPU), and for a per-element A each row block's nonzeros and
    # structure length) or "node" (K10: each round's rows over S shards;
    # the root round's rows B0 padded to a multiple of S).
    mesh: str = ""
    S: int = 0
    ms: int = 0
    Gs: int = 0
    blk_nnz: tuple = ()
    blk_index: tuple = ()
    # The round log and the root round's LP trace (``diag``; the root
    # trace's rows, ``search.root_trace_rows``).
    diag: bool = False
    trace_rows: int = 0


# The compile ledger's view of a signature: a capture with a new value of
# one of these fields is a static-argument flip (the engine and K5's route,
# the iteration budgets, the per-k mode, the optional warm inputs, the MoE
# seed's mode, the mesh and its shards, the diagnostics log: the reference's
# static ``diag``); with new values of the others only, a shape-bucket
# change.
_STATIC_FIELDS = ("device", "per_k", "ipm_iters", "root_chunk", "warm_iters", "mip_gap",
                  "max_rounds", "has_warm", "has_root_warm", "a_lanes", "moe", "decomp_steps",
                  "has_duals", "has_margin", "want_my", "engine", "lp_f64", "restart_tol",
                  "route", "C", "smem", "buf_len", "mesh", "S", "Gs", "diag")
_SHAPE_FIELDS = tuple(f for f in PlanSig._fields if f not in _STATIC_FIELDS)


def ledger_signatures(sig: PlanSig) -> Tuple[str, str]:
    """(static signature, shape signature) of a plan for the compile
    ledger (``obs.compile_ledger``)."""
    return (",".join(f"{f}={getattr(sig, f)!r}" for f in _STATIC_FIELDS),
            ",".join(f"{f}={getattr(sig, f)}" for f in _SHAPE_FIELDS))


def plan_sig(dev, L, cap, n_k, beam, m, nf, M, per_k, ipm_iters, ipm_warm_iters,
             root_warm_chunk, mip_gap, max_rounds, has_warm, has_root_warm, entry,
             moe_ctx=None, has_duals=False, has_margin=False, want_my=False,
             pdhg=None, mesh=None, diag=False) -> PlanSig:
    """The signature of a sweep's plan; ``moe_ctx`` = (w_max, e_max,
    decomp_steps) of a MoE sweep; ``pdhg`` = (lp_f64, restart_tol, route, C,
    smem, buf_len) of a sweep on the PDHG engine (:func:`pdhg_plan`), whose
    rounds all take K5's own chunk; ``mesh`` the mesh part
    (:func:`row_mesh_plan`, or ``("node", S, root_beam)``); ``diag`` the
    round log and the root LP trace (:func:`loop_route` refuses it on a
    node mesh)."""
    sp = entry.sparsity
    extra = {}
    if diag:
        extra.update(diag=True, trace_rows=_search.root_trace_rows(
            "ipm" if pdhg is None else "pdhg", int(ipm_iters), bool(root_warm_chunk)))
    B0 = min(cap, n_k)
    if mesh is not None and mesh[0] == "row":
        _, S, ms, Gs, blk_nnz, blk_index = mesh
        extra.update(mesh="row", S=int(S), ms=int(ms), Gs=int(Gs), blk_nnz=tuple(blk_nnz),
                     blk_index=tuple(blk_index))
    elif mesh is not None:
        _, S, root_beam = mesh
        extra.update(mesh="node", S=int(S))
        B0 = min(cap, max(n_k, int(root_beam)))
    if moe_ctx is not None:
        extra.update(moe=True, w_max=int(moe_ctx[0]), e_max=int(moe_ctx[1]),
                     decomp_steps=int(moe_ctx[2]), has_duals=bool(has_duals),
                     has_margin=bool(has_margin), want_my=bool(want_my))
    if pdhg is not None:
        lp_f64, rt, route, C, smem, buf_len = pdhg
        extra.update(engine="pdhg", lp_f64=bool(lp_f64), restart_tol=float(rt), route=route,
                     C=int(C), smem=int(smem), buf_len=int(buf_len))
        root_chunk = PDHG_DEFAULT_CHUNK
    else:
        root_chunk = IPM_DEFAULT_CHUNK if root_warm_chunk else int(ipm_iters)
    return PlanSig(
        device=str(torch.device(dev)), L=L, cap=cap, B0=B0,
        Bw=cap if beam is None else min(beam, cap), m=m, nf=nf, M=M, n_k=n_k, per_k=bool(per_k),
        ipm_iters=int(ipm_iters), root_chunk=root_chunk,
        warm_iters=int(ipm_iters if ipm_warm_iters is None else ipm_warm_iters),
        mip_gap=float(mip_gap), max_rounds=int(max_rounds), has_warm=bool(has_warm),
        has_root_warm=bool(has_root_warm), a_lanes=entry.A.dim() == 3, nnz=sp.nnz,
        nent=sp.nent, ncontrib=sp.ncontrib, index_len=int(sp.index.numel()), **extra,
    )


def pdhg_plan(entry, dev, pdhg_dtype, restart_tol) -> tuple:
    """The ``pdhg`` part of a PDHG sweep's :func:`plan_sig`: its iterate
    dtype, restart factor and K5's route on the entry's structure, through
    the module attribute ``ops.pdhg.kernel_route`` (as the K5 wrapper picks
    it, so a forced route forces both): on the card up to the largest
    cluster it schedules, on the CPU (no kernel) up to the largest size."""
    dev = torch.device(dev)
    f64 = pdhg_dtype == "f64"
    dt = torch.float64 if f64 else torch.float32
    c_max = _pdhg._cluster_max(dev, f64) if dev.type == "cuda" else _pdhg.CLUSTER_SIZES[-1]
    route, C, cplan = _pdhg.kernel_route(entry.sparsity, dt, c_max)
    rt = DEFAULT_RESTART_TOL if restart_tol is None else float(restart_tol)
    if cplan is None:
        return f64, rt, route, 0, 0, 0
    return f64, rt, route, C, cplan.smem, int(cplan.buf.numel())


def row_mesh_plan(entry, dev, S: int, lp_f64: bool) -> tuple:
    """The ``mesh`` part of a row-mesh sweep's :func:`plan_sig`: S, the
    padded rows a shard, a shard's group of the card's blocks in K6b's
    fused launch (0 on the CPU: no kernel), and for a per-element A (MoE
    nodes) each row block's nonzeros and structure length (the entry's
    ``mesh_blocks``)."""
    dev = torch.device(dev)
    elem = entry.per_element
    ms = _meshlp.pad_rows_to(entry.sparsity.m, S) // S
    Gs = _meshlp.fused_group(dev, S, lp_f64, elem) if dev.type == "cuda" else 0
    nnz = index = ()
    if elem:
        rb = entry.mesh_blocks(S)
        nnz = tuple(sp.nnz for sp in rb.sparsity)
        index = tuple(int(sp.index.numel()) for sp in rb.sparsity)
    return "row", S, ms, Gs, nnz, index


# Graph captures by signature (a plan captures its graph once), and plans
# built by signature (on the CPU too, where nothing is captured).
CAPTURES: Dict[PlanSig, int] = {}
PLANS_BUILT: Dict[PlanSig, int] = {}
# One process-wide turn at the card's graph work: a plan's capture and
# instantiation, its launch and the read of its answer. Two threads
# instantiating graphs with a conditional WHILE node at once deadlocked on
# the H100 (both inside cudaGraphInstantiate, the card idle),
# so a gateway's worker threads and its combiner take turns here; their host
# work (instance build, packing) still overlaps, and their launches were
# serialized on the one legacy stream anyway.
_GRAPH_LOCK = threading.Lock()

_STATE_FIELDS = SearchState._fields
# The round tail's state inputs, in its pointer table's order.
_TAIL_STATE = ("node_lo", "node_hi", "node_kidx", "node_bound", "active", "incumbent", "inc_w",
               "inc_n", "inc_y", "inc_kidx", "dropped_bound", "per_k_best", "node_v", "node_y",
               "node_z", "node_f", "node_warm", "stat_ipm_iters", "stat_rounds", "per_k_w",
               "per_k_n", "per_k_y", "per_k_dropped")
_RES_FIELDS = IPMResult._fields[:-1]  # untraced


def _ptrs(vals) -> ctypes.Array:
    return (ctypes.c_longlong * len(vals))(*[0 if v is None else int(v) for v in vals])


def _p(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


class LoopPlan:
    """Every buffer of one solve of signature ``sig``, and on the card its
    graph. One plan serves one solve in flight (``busy``)."""

    def __init__(self, sig: PlanSig):
        self.sig = sig
        dev = self.dev = torch.device(sig.device)
        L, cap, m, nf, M, n_k = sig.L, sig.cap, sig.m, sig.nf, sig.M, sig.n_k
        B0, Bw = sig.B0, sig.Bw
        f32, f64, b8 = DTYPE, BDTYPE, torch.bool
        self.layout = packed.dyn_layout(L, n_k, m, nf, M, sig.moe, sig.has_warm,
                                        sig.has_root_warm, sig.has_margin,
                                        has_duals=sig.has_duals)
        cuda = dev.type == "cuda"
        self.pinned = torch.empty(self.layout.nbytes, dtype=torch.uint8, pin_memory=cuda)
        self.blob = torch.empty(self.layout.nbytes, dtype=torch.uint8, device=dev)
        self.views = packed.dyn_views(self.blob, self.layout)
        self.rd_views = packed.rounding_views(self.views)
        # The LP's A: its values on the structure (a shared A, or a per-node
        # A for the root and the warm rows: each row's lane's, and in MoE
        # mode the row's k's expert-busy entries, which the head writes
        # every round), the base loaded from the static entry when it
        # changes; K1 also reads it dense (its certificate), K5 never (no
        # dense A on the PDHG: one (m, nf) row is ~80 MB at M=512). K5's
        # values are in its iterate dtype.
        self.pdhg = sig.engine == "pdhg"
        self.lp_dtype = f64 if sig.lp_f64 else f32
        self.per_node = sig.a_lanes or sig.moe
        # A row mesh's A is K6b's row blocks (the head writes a MoE row's
        # values into them), not K5's values.
        self.row_mesh, self.node_mesh = sig.mesh == "row", sig.mesh == "node"
        if self.row_mesh and sig.L != 1:
            raise ValueError(f"a row-mesh plan solves one sweep (L={sig.L})")
        self.index = torch.empty(sig.index_len, dtype=torch.int32, device=dev)
        self.A_rows = self.A = self.val_rows = self.vals = None
        if self.per_node:
            if not self.pdhg:
                self.A_rows = [torch.empty((L * B, m, nf), dtype=f32, device=dev)
                               for B in (B0, Bw)]
            if not self.row_mesh:
                self.val_rows = [torch.empty((L * B, sig.nnz), dtype=self.lp_dtype,
                                             device=dev) for B in (B0, Bw)]
        else:
            if not self.pdhg:
                self.A = torch.empty((m, nf), dtype=f32, device=dev)
            if not self.row_mesh:
                self.vals = torch.empty(sig.nnz, dtype=self.lp_dtype, device=dev)
        self.loaded = None
        # Two state buffers in the round tail's layout, its workspace after.
        views, offsets, end = tail_layout(L, cap, nf, m, M, n_k, sig.per_k)
        self.tail_offsets, self.tail_ws_off = offsets, end
        ws = 0
        if cuda:
            from ..kernels.build import library

            lib = library("round_tail")
            for B in (B0, Bw):
                need = int(lib.dtk_round_tail_smem_bytes(B, cap, M, int(sig.moe), n_k,
                                                         int(sig.per_k)))
                if need > TAIL_SMEM_LIMIT:
                    raise ValueError(f"round tail: a lane needs {need} bytes of shared memory "
                                     f"(B={B}, cap={cap}, M={M}, n_k={n_k})")
            ws = max(int(lib.dtk_round_tail_ws_bytes(L, B, cap, M)) for B in (B0, Bw))
        self.nbytes_state = end + -(-ws // 8) * 8
        self.bufs = [torch.zeros(self.nbytes_state, dtype=torch.uint8, device=dev)
                     for _ in range(2)]
        shared_pk = None
        if not sig.per_k:
            # Outside per-k mode the tail passes the per-k assignments
            # through: one copy, which the seed writes.
            shared_pk = (torch.zeros((L, n_k, M), dtype=f64, device=dev),
                         torch.zeros((L, n_k, M), dtype=f64, device=dev),
                         torch.zeros((L, n_k, M), dtype=f64, device=dev),
                         torch.zeros((L, n_k), dtype=f64, device=dev))
        self.states, self.gos = [], []
        for buf in self.bufs:
            outs = tail_views(buf, views)
            (lo, hi, kidx, bound, active, inc, inc_w, inc_n, inc_y, inc_kidx, dropped, pkb,
             nv, ny, nz, nfv, warm, st_iters, st_rounds, go) = outs[:20]
            pkw, pkn, pky, pkd = outs[20:] if sig.per_k else shared_pk
            self.states.append(SearchState(
                node_lo=lo, node_hi=hi, node_kidx=kidx, node_bound=bound, active=active,
                incumbent=inc, inc_w=inc_w, inc_n=inc_n, inc_y=inc_y, inc_kidx=inc_kidx,
                dropped_bound=dropped, per_k_best=pkb, per_k_w=pkw, per_k_n=pkn, per_k_y=pky,
                per_k_dropped=pkd, node_v=nv, node_y=ny, node_z=nz, node_f=nfv,
                node_warm=warm, stat_ipm_iters=st_iters, stat_rounds=st_rounds))
            self.gos.append(go)
        # The LP's inputs (rows of the larger round) and K1's outputs (the
        # root round's kept to the answer) and workspaces.
        R = L * max(B0, Bw)
        # The diagnostics log (a row a round, the control's) and the root
        # round's LP trace, in the LP's iterate dtype as its engine writes it.
        self.log = self.trace = None
        if sig.diag:
            self.log = torch.zeros((L, sig.max_rounds, RL_COLS), dtype=f64, device=dev)
            self.trace = torch.zeros((L * B0, sig.trace_rows, TRACE_COLS), dtype=self.lp_dtype,
                                     device=dev)
        self.lp_in = dict(
            b=torch.empty((R, m), dtype=f32, device=dev), c=torch.empty((R, nf), dtype=f32, device=dev),
            l=torch.empty((R, nf), dtype=f32, device=dev), u=torch.empty((R, nf), dtype=f32, device=dev),
            wv=torch.empty((R, nf), dtype=f32, device=dev), wy=torch.empty((R, m), dtype=f32, device=dev),
            wz=torch.empty((R, nf), dtype=f32, device=dev), wf=torch.empty((R, nf), dtype=f32, device=dev),
            wok=torch.empty(R, dtype=b8, device=dev), skip=torch.empty(R, dtype=b8, device=dev))
        self.res = [self._lp_out(L * B) for B in (B0, Bw)]
        self.ws = self.vec_ws = None
        if self.pdhg:
            self._k5_buffers(R)
            if self.row_mesh:
                self._k6b_buffers(R)
        elif cuda:
            need = [ipm_workspace(L * B, m, nf, f32, dev)[1:] for B in (B0, Bw)]
            vec, fac = max(v for v, _ in need), max(f for _, f in need)
            self.ws = torch.empty(fac // 4, dtype=f32, device=dev) if fac else None
            self.vec_ws = torch.empty(vec // 4, dtype=f32, device=dev) if vec else None
        self.frozen = torch.ones(L, dtype=b8, device=dev)
        self.ran = torch.zeros(L, dtype=b8, device=dev)
        self.ctl = torch.zeros(2, dtype=torch.int32, device=dev)
        if sig.moe:
            self._moe_buffers(R)
        elif self.node_mesh:
            # K2's dense entry a shard: each row's W, k and lane in, its
            # (obj, w, n) out.
            e = dict(dtype=f64, device=dev)
            self.Wr, self.kr = torch.zeros(R, **e), torch.zeros(R, **e)
            self.lp_out = (torch.zeros(R, **e), torch.zeros((R, M), **e),
                           torch.zeros((R, M), **e))
            self.inst_rows = [_lanes_of(L, B, dev).to(torch.int32) for B in (B0, Bw)]
            if cuda:
                from ..kernels.build import library

                with _on_device(dev):
                    kernels.check(library("round").dtk_round_prepare(M), "round prepare")
        self.alay = packed.AnswerLayout(
            M, n_k, m, nf, sig.moe, sig.per_k,
            (n_k, M, sig.e_max + 1) if sig.want_my else (),
            sig.max_rounds if sig.diag else 0,
            (n_k, sig.trace_rows, TRACE_COLS) if sig.diag else ())
        self.answer = torch.empty((L, self.alay.width), dtype=f64, device=dev)
        self.graph = ctypes.c_void_p(None)
        self.handle = ctypes.c_ulonglong(0)
        self.busy = False
        self._keep: list = []
        _memory.note_plan(_memory.device_bytes(vars(self), dev) if cuda else None)

    def _k5_buffers(self, R: int) -> None:
        """K5's buffers: in float64 mode its inputs (the head writes them)
        and its iteration-dtype outputs (the cast rounds them into the
        float32 result); each round's rows as K5 reads them; on the card
        the cluster route's ownership plan (copied from the entry's) or the
        grid route's workspace and grid, fixed here once a plan."""
        sig, dev = self.sig, self.dev
        L, m, nf, nnz = sig.L, sig.m, sig.nf, sig.nnz
        f64 = BDTYPE
        self.lp_in64 = self.res64 = None
        if sig.lp_f64:
            self.lp_in64 = {k: torch.empty((R, m if k in ("b", "wy") else nf), dtype=f64,
                                           device=dev) for k in ("b", "c", "l", "u", "wv", "wy")}
            self.res64 = [IPMResult(*(
                torch.empty(t.shape, dtype=f64, device=dev)
                if f in ("v", "obj", "rp_norm", "rd_norm", "mu", "y_dual", "z_dual", "f_dual")
                else t for f, t in zip(IPMResult._fields, r))) for r in self.res]
        self.k5_rows = []
        self.k5_buf = self.k5_ws = None
        self.k5_ws_sizes, self.k5_G = [(), ()], 0
        if self.row_mesh:
            return
        for i, B in enumerate((sig.B0, sig.Bw)):
            n = L * B
            lp = self.lp_in64 if sig.lp_f64 else self.lp_in
            vals = self.val_rows[i] if self.per_node else self.vals.as_strided((n, nnz), (0, 1))
            out = (self.res64 if sig.lp_f64 else self.res)[i]
            if self._traced(i):
                out = out._replace(trace_buf=self.trace)
            self.k5_rows.append(dict(
                vals=vals, **{k: lp[k][:n] for k in ("b", "c", "l", "u", "wv", "wy")},
                wok=self.lp_in["wok"][:n], skip=self.lp_in["skip"][:n], out=out))
        if dev.type != "cuda":
            return
        if sig.route == "cluster":
            _pdhg._cluster_max(dev, sig.lp_f64)  # prepares the kernel on this card
            self.k5_buf = torch.empty(sig.buf_len, dtype=torch.int32, device=dev)
        else:
            # A node mesh's launch is one shard's rows.
            self.k5_ws_sizes = [_pdhg.route_ws_sizes("grid", self._launch_rows(B), m, nf,
                                                     sig.lp_f64) for B in (sig.B0, sig.Bw)]
            self.k5_ws = torch.empty(max(sum(z) for z in self.k5_ws_sizes), dtype=torch.uint8,
                                     device=dev)
            self.k5_G = _pdhg._grid_blocks(dev, sig.lp_f64)

    def _launch_rows(self, B: int) -> int:
        """The rows of one LP launch of a round of ``B`` rows a lane: all of
        them, or on a node mesh one shard's."""
        R = self.sig.L * B
        if not self.node_mesh:
            return R
        if R % self.sig.S:
            raise ValueError(f"{R} rows do not split over {self.sig.S} shards")
        return R // self.sig.S

    def _k6b_buffers(self, R: int) -> None:
        """A row mesh's buffers: the S row blocks of b, of the warm y and of
        K6b's dual (the head and K6b write them, the gather reads the
        last), A's blocks (a shared A's dense blocks and transposes, or a
        per-element A's block structures and every row's values on them,
        with the places of the 2M expert-busy entries), and on the card
        each shard's workspace, parts and done flags and the replicated
        outputs of shards 1..S-1, fixed here for slices of up to BMAX rows.
        Every one of these that K6b reads it writes first in the same
        launch (``pdhg_sharded_kernel.cu``), so none is zeroed per round."""
        sig, dev = self.sig, self.dev
        S, ms, nf, dt = sig.S, sig.ms, sig.nf, self.lp_dtype
        self.b_blk, self.wy_blk, self.y_blk = (torch.zeros((S, R, ms), dtype=dt, device=dev)
                                               for _ in range(3))
        self.elem = bool(sig.blk_nnz)
        self.A_blk = self.At_blk = self.blk_vals = self.blk_index = None
        self.blk_sparsity = self.gky_mesh = None
        if self.elem:
            self.blk_off = [R * sum(sig.blk_nnz[:s]) for s in range(S)]
            self.blk_vals = torch.empty(R * sum(sig.blk_nnz), dtype=dt, device=dev)
            self.blk_index = [torch.empty(n, dtype=torch.int32, device=dev)
                              for n in sig.blk_index]
            self.gky_mesh = torch.zeros((2, 2 * sig.M), dtype=torch.int64, device=dev)
        else:
            self.A_blk = [torch.empty((ms, nf), dtype=dt, device=dev) for _ in range(S)]
            self.At_blk = [torch.empty((nf, ms), dtype=dt, device=dev) for _ in range(S)]
        self.k6b = None
        if dev.type != "cuda":
            return
        from ..kernels.build import library

        BM = _pdhg.BMAX
        ws = int(library("pdhg_sharded").dtk_pdhgs_ws_bytes(BM, ms, nf, sig.Gs,
                                                             int(sig.lp_f64)))
        kw, k64 = dict(dtype=dt, device=dev), dict(dtype=BDTYPE, device=dev)
        self.k6b = []
        for s in range(S):
            sh = dict(ws=torch.empty(ws, dtype=torch.uint8, device=dev),
                      part=torch.empty((BM, nf), **kw), part64=torch.empty((BM, nf), **k64),
                      sq=torch.empty((BM, _meshlp.N_SQ), **kw), srp=torch.empty(BM, **kw),
                      sby=torch.empty(BM, **kw), s64=torch.empty(BM, **k64),
                      done=torch.empty(BM, dtype=torch.int32, device=dev))
            if s:
                sh["out"] = IPMResult(
                    v=torch.empty((BM, nf), **kw), bound=torch.empty(BM, **k64),
                    obj=torch.empty(BM, **kw), rp_norm=torch.empty(BM, **kw),
                    rd_norm=torch.empty(BM, **kw), mu=torch.empty(BM, **kw),
                    converged=torch.empty(BM, dtype=torch.bool, device=dev),
                    reduced=torch.empty((BM, nf), **k64), y_dual=None,
                    z_dual=torch.empty((BM, nf), **kw), f_dual=torch.empty((BM, nf), **kw),
                    iters_run=torch.empty(BM, dtype=torch.int32, device=dev))
            self.k6b.append(sh)

    def _moe_buffers(self, R: int) -> None:
        """The MoE seed's and rounds' buffers: K7's problem in both dtypes,
        its multipliers, workspaces and outputs, the hint and warm rows and
        K2's outputs for them, each row's W and k and K2's outputs for the
        LP rows, the answer's duals block. K7's launch layout (the ascent's
        units, grid and owner states, the float64 evaluation's units) is
        fixed here, once a plan."""
        sig, dev = self.sig, self.dev
        L, n_k, M = sig.L, sig.n_k, sig.M
        Y = sig.e_max + 1
        f32, f64, i32 = DTYPE, BDTYPE, torch.int32

        def e(*shape, dtype=f64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        ND = len(RD_DEV_FIELDS)
        self.rdv32, self.rdv64 = e(L, ND, M, dtype=f32), e(L, ND, M)
        self.bp32, self.E32, self.bp64, self.E64 = e(L, dtype=f32), e(L, dtype=f32), e(L), e(L)
        self.ks32, self.Ws32 = e(L, n_k, dtype=f32), e(L, n_k, dtype=f32)
        self.P0, self.best = (e(L, n_k * (2 + M), dtype=f32) for _ in range(2))
        self.count = e(L * n_k * M, dtype=i32)
        self.m_y, self.any_ok = e(L, n_k, M, Y), e(L, n_k, M, dtype=torch.uint8)
        self.hint_w, self.hint_flat = e(L, n_k, M), e(L, n_k, M, dtype=i32)
        self.lam, self.mu, self.tau, self.theta = e(L, n_k), e(L, n_k), e(L, n_k, M), e(L, n_k, M)
        self.bound = e(L, n_k)
        self.duals_out = e(L, 3 * n_k + n_k * M)
        # K2's hint rows (L n_k), warm rows (L), LP rows (R): LP points and
        # (W, k) in, (obj, w, n, y) out; each row's lane.
        self.hint_v = e(L * n_k, 3 * M)
        self.hint_out = (e(L * n_k), e(L * n_k, M), e(L * n_k, M), e(L * n_k, M))
        self.warm_v, self.warm_W, self.warm_k = e(L, 3 * M), e(L), e(L)
        self.warm_out = (e(L), e(L, M), e(L, M), e(L, M))
        self.Wr, self.kr = e(R), e(R)
        self.lp_out = (e(R), e(R, M), e(R, M), e(R, M))
        self.inst_hint = _lanes_of(L, sig.n_k, dev).to(i32)
        self.inst_lane = torch.arange(L, device=dev, dtype=i32)
        self.inst_rows = [_lanes_of(L, B, dev).to(i32) for B in (sig.B0, sig.Bw)]
        self.gky_pos = e(2, M, dtype=i32)
        self.k7 = self.tab = None
        if dev.type != "cuda":
            return
        from ..kernels.build import library
        from ..ops import decomp as D

        sms = D._sm_count(dev)
        asc = None
        if sig.decomp_steps > 0 and not sig.has_margin:
            asc = D.ascent_layout(L, n_k, M, sig.w_max, sig.e_max, sms,
                                  lambda pb: D._ascent_grid(str(dev), M, pb))
        ev = D.unit_plan(L, n_k, M, sig.w_max, sig.e_max, D.F64_BLOCKS_PER_SM * sms)
        lib = library("decomp")
        n_cells = L * n_k * M * sig.w_max * Y * D.N_CANDS
        self.k7 = dict(
            ascent=asc, eval=ev,
            ascent_ws=None if asc is None else torch.empty(
                int(lib.dtk_decomp_ascent_ws_bytes(asc[0].units, n_cells, M, asc[1])),
                dtype=torch.uint8, device=dev),
            eval_ws=torch.empty(int(lib.dtk_decomp_f64_ws_bytes(ev.units, Y)),
                                dtype=torch.uint8, device=dev),
            adam=D._adam_table(sig.decomp_steps, str(dev)) if asc is not None else None)
        self.tab = moe_table_workspace(library("round_moe"), M, max(R, L * n_k), dev)

    def _lp_out(self, R: int) -> IPMResult:
        f32, dev, m, nf = DTYPE, self.dev, self.sig.m, self.sig.nf
        return IPMResult(
            v=torch.empty((R, nf), dtype=f32, device=dev),
            bound=torch.empty(R, dtype=BDTYPE, device=dev),
            obj=torch.empty(R, dtype=f32, device=dev),
            rp_norm=torch.empty(R, dtype=f32, device=dev),
            rd_norm=torch.empty(R, dtype=f32, device=dev),
            mu=torch.empty(R, dtype=f32, device=dev),
            converged=torch.empty(R, dtype=torch.bool, device=dev),
            reduced=torch.empty((R, nf), dtype=BDTYPE, device=dev),
            y_dual=torch.empty((R, m), dtype=f32, device=dev),
            z_dual=torch.empty((R, nf), dtype=f32, device=dev),
            f_dual=torch.empty((R, nf), dtype=f32, device=dev),
            iters_run=torch.empty(R, dtype=torch.int32, device=dev),
        )

    def __del__(self):
        if getattr(self, "graph", None) is not None and self.graph.value:
            try:
                from ..kernels.build import library

                library("bnb_loop").dtk_bnb_graph_free(self.graph)
            except Exception:  # noqa: BLE001 - interpreter teardown
                pass
            self.graph = ctypes.c_void_p(None)

    # ------------------------------------------------------------ inputs

    def stage(self, lanes) -> None:
        """The dynamic half of ``lanes`` into the plan's host buffer, then
        one copy to the card (on the caller's stream)."""
        packed.pack_dynamic(lanes, self.layout, self.pinned.numpy())
        packed.upload(self.pinned, self.dev, out=self.blob)

    def data(self, entry) -> SweepData:
        """The sweep's data as views of the plan's blob and the entry (on
        the PDHG with K5's values on its structure, on a row mesh with the
        entry's row blocks)."""
        v = self.views
        values, gky_pos = entry.pdhg_values() if self.pdhg else (None, None)
        shards = None
        if self.row_mesh:
            shards = entry.mesh_blocks(self.sig.S, None if self.elem else self.lp_dtype)
        return SweepData(
            A=entry.A, b_k=v["b_k"], c_k=v["c_k"], int_mask=v["int_mask"], ks=v["ks"],
            Ws=v["Ws"], obj_const=v["obj_const"], rd=self.rd_views,
            rd_packed=v["rd"], gky=v.get("gky"), A_sparsity=entry.sparsity,
            A_values=values, gky_pos=gky_pos, A_shards=shards,
            A_k1_values=None if self.per_node or self.pdhg else entry.values, A_checked=True,
        )

    def load_static(self, entry) -> None:
        """The LP's A, structure and values from ``entry`` into the plan's
        buffers, when another entry was loaded (copies on the card); in MoE
        mode the places of the expert-busy entries in a row's values; on
        the PDHG, K5's values (``entry.pdhg_values()``) and on the card the
        cluster route's ownership plan of the entry's pattern."""
        if self.loaded is entry:
            return
        self.index.copy_(entry.sparsity.index)
        if self.row_mesh:
            self._load_k6b(entry)
        elif self.pdhg:
            self._load_k5(entry)
        elif self.per_node:
            for i, B in enumerate((self.sig.B0, self.sig.Bw)):
                R = self.sig.L * B
                if entry.A.dim() == 3:
                    lanes = _lanes_of(self.sig.L, B, self.dev)
                    self.A_rows[i].copy_(entry.A[lanes])
                    self.val_rows[i].copy_(entry.values[lanes])
                else:
                    self.A_rows[i].copy_(entry.A.expand(R, *entry.A.shape))
                    self.val_rows[i].copy_(entry.values.expand(R, -1))
            if self.sig.moe:
                self.gky_pos.copy_(entry.pdhg_values()[1])
        else:
            self.A.copy_(entry.A)
            self.vals.copy_(entry.values)
        self.loaded = entry

    def _load_k5(self, entry) -> None:
        sig = self.sig
        values, gky_pos = entry.pdhg_values()
        if self.per_node:
            for i, B in enumerate((sig.B0, sig.Bw)):
                if values.shape[0] > 1:
                    self.val_rows[i].copy_(values[_lanes_of(sig.L, B, self.dev)])
                else:
                    self.val_rows[i].copy_(values.expand(sig.L * B, -1))
            if sig.moe:
                self.gky_pos.copy_(gky_pos)
        else:
            self.vals.copy_(values[0])
        if self.k5_buf is not None:
            cplan = _pdhg.cluster_plan(entry.sparsity, 8 if sig.lp_f64 else 4, sig.C)
            if cplan.smem != sig.smem or cplan.buf.numel() != sig.buf_len:
                raise ValueError("the entry's cluster plan does not fit the plan's signature")
            _pdhg.check_cluster_layout(cplan, sig.m, sig.nf, sig.lp_f64)
            self.k5_buf.copy_(cplan.buf)

    def _load_k6b(self, entry) -> None:
        """A row mesh's A from the entry's row blocks (``mesh_blocks``, made
        once an entry): a shared A's dense blocks and transposes; or each
        block's structure, every row's base values on it (the head writes a
        row's expert-busy entries over them every round) and those entries'
        places in the blocks' values."""
        sig, S = self.sig, self.sig.S
        if not self.elem:
            blocks = entry.mesh_blocks(S, self.lp_dtype)
            for s in range(S):
                self.A_blk[s].copy_(blocks.A[s])
                self.At_blk[s].copy_(blocks.At[s])
            return
        rb = entry.mesh_blocks(S)
        values, gky_pos = entry.pdhg_values()
        if values.shape[0] != 1:
            raise ValueError("a row-mesh plan takes one A for every row")
        base = values[0].to(self.lp_dtype)
        R = self.b_blk.shape[1]
        nnz = list(sig.blk_nnz)
        blk_of = torch.empty(base.shape[0], dtype=torch.int64, device=self.dev)
        pos_in = torch.empty_like(blk_of)
        for s, (sp, take) in enumerate(zip(rb.sparsity, rb.take)):
            if sp.nnz != nnz[s] or int(sp.index.numel()) != sig.blk_index[s]:
                raise ValueError("the entry's row blocks do not fit the plan's signature")
            self.blk_index[s].copy_(sp.index)
            self._blk_vals(s).copy_(base[take].expand(R, -1))
            blk_of[take] = s
            pos_in[take] = torch.arange(sp.nnz, device=self.dev)
        if sig.moe:
            g = gky_pos.reshape(-1)
            sj = blk_of[g]
            off = torch.tensor(self.blk_off, dtype=torch.int64, device=self.dev)
            stride = torch.tensor(nnz, dtype=torch.int64, device=self.dev)
            self.gky_mesh.copy_(torch.stack([off[sj] + pos_in[g], stride[sj]]))
        self.blk_sparsity = rb.sparsity

    def _blk_vals(self, s: int) -> torch.Tensor:
        """Block s's values, one row a round's row (R, nnz_s)."""
        n = self.sig.blk_nnz[s]
        R = self.b_blk.shape[1]
        return self.blk_vals[self.blk_off[s]:self.blk_off[s] + R * n].view(R, n)

    def _lp_A(self, i: int) -> torch.Tensor:
        return self.A_rows[i] if self.per_node else self.A

    # -------------------------------------------------------- plain (CPU)

    def run_plain(self, entry, warm=None, root_warm=None,
                  seeded: Optional[SearchState] = None) -> np.ndarray:
        """The plan's loop with the plain versions: the answer (L, width).
        ``seeded`` replaces the seed's state (tests)."""
        sig, v = self.sig, self.views
        self.load_static(entry)
        data = self.data(entry)
        st = root_state(v["lo_k"], v["hi_k"], sig.M, sig.cap, sig.m, root_warm)
        moe_out = None
        if sig.moe:
            st, *moe_out = self.seed_moe_reference(st, data)
        if warm is not None:
            st = seed_warm(st, data, warm, sig.moe, MOE_LOCAL_MOVES_WARM)
        _copy_state(self.states[0], st if seeded is None else seeded)
        control_reference(self, init=True, state=self.states[0])
        self._round_plain(data, 0, 1, 0)
        go = control_reference(self, go=self.gos[1])
        while go:
            self._round_plain(data, 1, 0, 1)
            control_reference(self, go=self.gos[0])
            self._round_plain(data, 0, 1, 1)
            go = control_reference(self, go=self.gos[1])
        self.answer.copy_(answer_reference(self, self.states[1], moe_out))
        return self.answer.numpy().copy()

    def moe_problems(self):
        """K7's problem of every lane in float32 and float64, taken from the
        upload (the seed's MoE prep's plain version)."""
        sig, v = self.sig, self.views
        rows = [_RD_ROWS[f] for f in RD_DEV_FIELDS]
        rdv64 = v["rd"][:, rows].contiguous()
        sc = v["rd_scalars"]
        bp, E = sc[:, 0].contiguous(), sc[:, 1].contiguous()
        p64 = DecompBatch(rdv=rdv64, bp=bp, E=E, ks=v["ks"], Ws=v["Ws"], w_max=sig.w_max,
                          e_max=sig.e_max)
        f32 = DTYPE
        p32 = DecompBatch(rdv=rdv64.to(f32), bp=bp.to(f32), E=E.to(f32), ks=v["ks"].to(f32),
                          Ws=v["Ws"].to(f32), w_max=sig.w_max, e_max=sig.e_max)
        return p32, p64

    def stored_duals(self):
        """The upload's stored duals as (lam (L, n_k), mu, tau (L, n_k, M)),
        or None."""
        if not self.sig.has_duals:
            return None
        n_k, M = self.sig.n_k, self.sig.M
        d = self.views["duals"]
        return d[:, :n_k], d[:, n_k:2 * n_k], d[:, 2 * n_k:].reshape(-1, n_k, M)

    def seed_moe_reference(self, state: SearchState, data: SweepData):
        """Plain version of the seed's MoE mode (the graph's K7 launches,
        folds, MoE seed phases and K2's hint rows): ``search.
        seed_root_bounds`` on the upload's problem. Returns ``(state, duals,
        raw_bounds, m_y)``; a margin tick's duals are the stored ones."""
        sig, v = self.sig, self.views
        init = self.stored_duals()
        if sig.has_margin:
            state, _, raw, m_y = seed_root_bounds(state, data, None, None, 0, init,
                                                  margin=v["margin"])
            return state, init, raw, m_y
        p32, p64 = self.moe_problems()
        return seed_root_bounds(state, data, p32, p64, sig.decomp_steps, init_duals=init)

    def head_moe_reference(self, data: SweepData, state: SearchState, which: int) -> None:
        """Plain version of the head's MoE mode: each row's k's expert-busy
        entries into its dense A (IPM only) and its values, its W and k."""
        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        R, M = sig.L * B, sig.M
        kidx = state.node_kidx[:, :B].reshape(R).long()
        lane = _lanes_of(sig.L, B, self.dev)
        g = data.gky[lane, kidx]  # (R, 2, M)
        ar = torch.arange(M, device=self.dev)
        if self.A_rows is not None:
            A = self.A_rows[which]
            A[:, 4 * M + ar, 2 * M + ar] = g[:, 0]
            A[:, 5 * M + ar, 2 * M + ar] = g[:, 1]
        rows = torch.arange(R, device=self.dev)[:, None]
        vals = self.val_rows[which]
        pos = self.gky_pos.long()
        vals[rows, pos[0]] = g[:, 0]
        vals[rows, pos[1]] = g[:, 1]
        self.Wr[:R] = data.Ws[lane, kidx]
        self.kr[:R] = data.ks[lane, kidx]

    def head_pdhg_reference(self, data: SweepData, state: SearchState, which: int) -> dict:
        """Plain version of the head's PDHG mode: ``round_inputs``' rows,
        b, c, the box and the warm v and y in K5's iterate dtype, the warm
        flag cleared where a component of the row's warm v, y, z or f is
        not finite (the K5 wrapper's test); a MoE row's values and its W
        and k are written by :meth:`head_moe_reference` (on a row mesh by
        :meth:`head_mesh_reference`)."""
        B = (self.sig.B0, self.sig.Bw)[which]
        ins = round_inputs(data, state, B, self.frozen)
        w, dt = ins.warm, self.lp_dtype
        fin = (w.ok.to(torch.bool) & torch.isfinite(w.v).all(1) & torch.isfinite(w.y).all(1)
               & torch.isfinite(w.z).all(1) & torch.isfinite(w.f).all(1))
        if self.sig.moe and not self.row_mesh:
            self.head_moe_reference(data, state, which)
        return dict(b=ins.b.to(dt), c=ins.c.to(dt), l=ins.lo.to(dt), u=ins.hi.to(dt),
                    wv=w.v.to(dt), wy=w.y.to(dt), wz=w.z, wf=w.f, wok=fin, skip=ins.skip)

    def _round_plain(self, data: SweepData, src: int, dst: int, which: int) -> None:
        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        state = self.states[src]
        ins = round_inputs(data, state, B, self.frozen)
        rounded = None
        if self.row_mesh:
            res = self.k6b_reference(data, state, which)
        elif self.node_mesh:
            res, rounded = self.node_reference(data, state, ins, which)
        else:
            if sig.moe:
                self.head_moe_reference(data, state, which)
            res = self._lp_plain(data, ins, which, slice(None))
        keep = self.res[which]
        for f in _RES_FIELDS:
            getattr(keep, f).copy_(getattr(res, f))
        if self._traced(which):
            self.trace.copy_(res.trace_buf)
        if sig.moe and rounded is None:
            rounded = round_rows(data, keep, ins.kidx, ins.lane)
        out, go = round_tail(data, state, keep, sig.mip_gap, B, rounded, self.frozen, sig.per_k)
        _copy_state(self.states[dst], out)
        self.gos[dst].copy_(go)

    def _traced(self, which: int) -> bool:
        """Whether round ``which``'s LP runs with its trace on: the root
        round's (``which`` 0) of a diagnostics plan."""
        return which == 0 and self.sig.diag

    def _lp_plain(self, data: SweepData, ins, which: int, rows: slice) -> IPMResult:
        """K1's or K5's plain version on ``ins`` (the round's ``rows``)."""
        if self.pdhg:
            return self.k5_reference(data, ins, which, rows)
        sig = self.sig
        iters, chunk = ((sig.ipm_iters, sig.root_chunk),
                        (sig.warm_iters, IPM_DEFAULT_CHUNK))[which]
        A = self._lp_A(which)
        return ipm_solve_batch(
            LPBatch(A=A if A.dim() == 2 else A[rows], b=ins.b, c=ins.c, l=ins.lo, u=ins.hi),
            iters=iters, warm=ins.warm, skip=ins.skip, chunk=chunk,
            sparsity=data.A_sparsity, trace=self._traced(which), _checked=True,
        )

    def k5_reference(self, data: SweepData, ins, which: int, rows: slice = slice(None)
                     ) -> IPMResult:
        """Plain version of a PDHG round's LP (K5, then in float64 mode the
        cast): the round's ``rows`` through ``search.pdhg_solve_batch`` on
        the plan's values, as ``search.lp_solve`` solves them, cast to the
        search's float32."""
        sig = self.sig
        vals = self.k5_rows[which]["vals"][rows]
        res = _search.pdhg_solve_batch(
            LPBatch(A=ElemA(vals, data.A_sparsity), b=ins.b, c=ins.c, l=ins.lo, u=ins.hi),
            iters=(sig.ipm_iters, sig.warm_iters)[which], restart_tol=sig.restart_tol,
            warm=ins.warm, skip=ins.skip, dtype="f64" if sig.lp_f64 else "f32",
            trace=self._traced(which))
        return cast_lp_result(res, DTYPE)

    def node_reference(self, data: SweepData, state: SearchState, ins, which: int):
        """Plain version of a node-mesh round's LP and rounding
        (``search._node_sharded`` on one device): the head's W and k (and a
        MoE row's values), then each shard's rows in order through the LP
        engine and K2 (its MoE mode for MoE rows). Returns ``(res,
        rounded)``, every row's."""
        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        per = self._launch_rows(B)
        if sig.moe:
            self.head_moe_reference(data, state, which)
        else:
            self.Wr[:sig.L * B] = data.Ws[ins.lane, ins.kidx]
            self.kr[:sig.L * B] = data.ks[ins.lane, ins.kidx]
        parts, rounded = [], []
        for s in range(sig.S):
            rows = slice(s * per, (s + 1) * per)
            part = _ins_rows(ins, rows)
            res = self._lp_plain(data, part, which, rows)
            parts.append(res)
            rounded.append(round_rows(data, res, part.kidx, part.lane))
        res = IPMResult(*(None if parts[0][f] is None else torch.cat([p[f] for p in parts])
                          for f in range(len(IPMResult._fields))))
        return res, tuple(torch.cat([r[i] for r in rounded]) for i in range(len(rounded[0])))

    def head_mesh_reference(self, data: SweepData, state: SearchState, which: int) -> dict:
        """Plain version of the head's row-mesh mode: the LP's b and warm y
        into the plan's S row blocks (zero-padded rows, in the iterate
        dtype), a MoE row's expert-busy entries into its blocks' values and
        its W and k; returns the rest of the head's rows (c, l, u, warm v in
        the iterate dtype, the warm verdict on the full arrays, skip)."""
        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        R, S, ms = sig.L * B, sig.S, sig.ms
        hd = self.head_pdhg_reference(data, state, which)
        pad = S * ms - sig.m
        b = torch.nn.functional.pad(hd.pop("b"), (0, pad))
        wy = torch.nn.functional.pad(hd.pop("wy"), (0, pad))
        for s in range(S):
            self.b_blk[s, :R] = b[:, s * ms:(s + 1) * ms]
            self.wy_blk[s, :R] = wy[:, s * ms:(s + 1) * ms]
        if sig.moe:
            kidx = state.node_kidx[:, :B].reshape(R).long()
            lane = _lanes_of(sig.L, B, self.dev)
            g = data.gky[lane, kidx].reshape(R, 2 * sig.M)
            off, stride = self.gky_mesh
            at = off[None, :] + torch.arange(R, device=self.dev)[:, None] * stride[None, :]
            self.blk_vals[at.reshape(-1)] = g.reshape(-1).to(self.lp_dtype)
            self.Wr[:R] = data.Ws[lane, kidx]
            self.kr[:R] = data.ks[lane, kidx]
        del hd["wz"], hd["wf"]
        return hd

    def k6b_reference(self, data: SweepData, state: SearchState, which: int) -> IPMResult:
        """Plain version of a row-mesh round's LP: the head's mesh mode, the
        row-sharded PDHG's plain version (``ops.meshlp.
        sharded_pdhg_reference``) on the plan's blocks, its dual blocks
        into the plan's and back in full coordinates (the gather's plain
        version), cast to the search's float32: what ``search.lp_solve``
        computes through ``sharded_pdhg`` on the round's rows."""
        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        R, S, ms = sig.L * B, sig.S, sig.ms
        hd = self.head_mesh_reference(data, state, which)
        if self.elem:
            A_b = [ElemA(self._blk_vals(s)[:R], self.blk_sparsity[s]) for s in range(S)]
        else:
            A_b = list(self.A_blk)
        res = _meshlp.sharded_pdhg_reference(
            A_b, [self.b_blk[s, :R] for s in range(S)], hd["c"], hd["l"], hd["u"],
            (sig.ipm_iters, sig.warm_iters)[which], _default_tol_pdhg(self.lp_dtype),
            sig.restart_tol, wv=hd["wv"], wy=[self.wy_blk[s, :R] for s in range(S)],
            wok=hd["wok"], skip=hd["skip"], chunk=PDHG_DEFAULT_CHUNK, trace=self._traced(which))
        for s in range(S):
            self.y_blk[s, :R] = res.y_dual[:, s * ms:(s + 1) * ms]
        y = _meshlp.gather_rows_reference([self.y_blk[s, :R] for s in range(S)], sig.m)
        return cast_lp_result(res._replace(y_dual=y), DTYPE)

    # ------------------------------------------------------- graph (card)

    def run(self, entry, warm=None, root_warm=None) -> np.ndarray:
        """The solve: the graph on the card, the plain loop on the CPU."""
        if kernels.on_cuda(self.blob):
            return self.run_graph(entry)
        return self.run_plain(entry, warm, root_warm)

    def run_graph(self, entry) -> np.ndarray:
        """One launch of the plan's graph (captured on first use) on the
        caller's stream, then one read of the answer."""
        from ..kernels.build import library

        lib = library("bnb_loop")
        with _GRAPH_LOCK, _on_device(self.dev):
            self.load_static(entry)
            if not self.graph.value:
                self._capture(entry)
            err = lib.dtk_bnb_graph_launch(self.graph, _stream_handle(self.dev))
            kernels.check(err, "bnb_graph")
            ans = packed.read_answer(self.answer)
        count_graph_launches(self.sig, ans)
        return ans

    def _capture(self, entry) -> None:
        from ..kernels.build import library

        lib = library("bnb_loop")
        t0 = time.perf_counter()
        with _compile_ledger.capture_open():
            self._capture_graph(lib, entry)
        CAPTURES[self.sig] = CAPTURES.get(self.sig, 0) + 1
        _compile_ledger.note_capture(*ledger_signatures(self.sig),
                                     (time.perf_counter() - t0) * 1e3)

    def _capture_graph(self, lib, entry) -> None:
        graph, handle = ctypes.c_void_p(None), ctypes.c_ulonglong(0)
        kernels.check(lib.dtk_bnb_graph_new(ctypes.byref(graph), ctypes.byref(handle)),
                      "bnb_graph create")
        # A stream of the plan's own (a capture needs one that is not the
        # legacy default stream; torch's are non-blocking).
        stream = torch.cuda.Stream(device=self.dev) if self.dev.type == "cuda" else None
        sh = ctypes.c_void_p(0 if stream is None else stream.cuda_stream)
        data = self.data(entry)
        parts = []
        steps = (
            lambda: (self._seed(lib, data, sh), self._control(lib, sh, init=True),
                     self._round(data, sh, 0, 1, 0), self._control(lib, sh, go=1, h=handle)),
            lambda: (self._round(data, sh, 1, 0, 1), self._control(lib, sh, go=0, h=handle),
                     self._round(data, sh, 0, 1, 1), self._control(lib, sh, go=1, h=handle)),
            lambda: self._answer(lib, sh),
        )
        try:
            for step in steps:
                kernels.check(lib.dtk_bnb_capture_begin(sh), "bnb_graph capture")
                part = ctypes.c_void_p(None)
                try:
                    step()
                finally:
                    err = lib.dtk_bnb_capture_end(sh, ctypes.byref(part))
                    if part.value:
                        parts.append(part)
                kernels.check(err, "bnb_graph capture")
            err = lib.dtk_bnb_graph_finish(graph, *parts)
            parts = []  # finish takes them
            kernels.check(err, "bnb_graph instantiate")
        except BaseException:
            for part in parts:
                lib.dtk_bnb_graph_discard(part)
            lib.dtk_bnb_graph_free(graph)
            raise
        self.graph, self.handle = graph, handle
        self._stream = stream

    def _keep_ptrs(self, vals) -> int:
        """The address of a pointer table the plan keeps alive."""
        arr = _ptrs(vals)
        self._keep = self._keep[-63:] + [arr]  # read only during the call
        return ctypes.addressof(arr)

    def _state_ptrs(self, i: int) -> list:
        st = self.states[i]
        return [getattr(st, f).data_ptr() for f in _STATE_FIELDS]

    def _seed(self, lib, data: SweepData, sh) -> None:
        """The seed: the root frontier (and a dense sweep's warm hint), and
        for a MoE sweep K7's problem gathered from the upload, then
        :meth:`_seed_moe`."""
        sig, v = self.sig, self.views
        rw = [v.get(k) for k in ("rw_ok", "rw_v", "rw_y", "rw_z", "rw_f")]
        wk = [v.get(k) for k in ("warm_kidx", "warm_w", "warm_n")]
        moe = [None] * 12
        if sig.moe:
            moe = [v["rd_scalars"], v.get("duals"), self.rdv32, self.rdv64, self.bp32,
                   self.E32, self.bp64, self.E64, self.ks32, self.Ws32, self.P0, self.count]
        ptrs = self._keep_ptrs([_p(v["lo_k"]), _p(v["hi_k"]), *map(_p, rw), *map(_p, wk),
                                _p(v["Ws"]), _p(v["ks"]), _p(v["rd"]), _p(v["obj_const"]),
                                *self._state_ptrs(0), *map(_p, moe)])
        rows = [_RD_ROWS[f] for f in RD_DEV_FIELDS] if sig.moe else []
        dims = self._keep_ptrs_int([
            sig.L, sig.cap, sig.nf, sig.m, sig.M, sig.n_k, int(sig.has_root_warm),
            int(sig.has_warm and not sig.moe), PACKED_ROWS * sig.M, int(sig.moe), len(rows),
            sig.L * sig.n_k * sig.M if sig.moe else 0, *(rows + [0] * (_DEV_ROWS - len(rows)))])
        kernels.check(lib.dtk_bnb_seed(ptrs, dims, sh), "bnb_seed")
        if sig.moe:
            self._seed_moe(lib, sh)

    def _seed_moe(self, lib, sh) -> None:
        """The MoE seed (``search.seed_root_bounds`` and ``seed_warm``):
        cold, K7's ascent and its float64 evaluation with the hint; warm,
        the evaluation at the stored duals; a margin tick, neither (the
        uploaded bounds); then the MoE seed's phases around K2's hint and
        warm rows."""
        from ..kernels.build import library
        from ..ops.decomp import ADAM_F32

        sig, v, P = self.sig, self.views, kernels.ptr
        L, n_k, M = sig.L, sig.n_k, sig.M
        cold = sig.decomp_steps > 0 and not sig.has_margin
        if not sig.has_margin:
            dlib = library("decomp")
            k7 = self.k7
            params = self.P0
            if cold:
                plan, per_block = k7["ascent"]
                ws = k7["ascent_ws"]
                err = dlib.dtk_decomp_ascent_f32(
                    P(self.rdv32), P(self.bp32), P(self.E32), P(self.ks32), P(self.Ws32), L,
                    n_k, M, sig.w_max, sig.e_max, P(k7["adam"]), sig.decomp_steps, *ADAM_F32,
                    P(self.P0), plan.chunk_w, plan.n_chunks, plan.grid, per_block, P(ws),
                    ws.numel(), P(self.best), sh)
                kernels.check(err, "decomp ascent")
                params = self.best
            err = dlib.dtk_decomp_theta_f64(
                P(params), ctypes.c_void_p(None), P(v["ks"]), L, n_k, M, P(self.lam),
                P(self.mu), P(self.tau), P(self.theta), sh)
            kernels.check(err, "decomp_theta")
            ev, ws = k7["eval"], k7["eval_ws"]
            err = dlib.dtk_decomp_eval_f64(
                P(self.rdv64), P(self.bp64), P(self.E64), P(v["ks"]), P(v["Ws"]), L, n_k, M,
                sig.w_max, sig.e_max, P(self.lam), P(self.mu), P(self.theta), int(cold),
                ev.chunk_w, ev.n_chunks, P(ws), ws.numel(), P(self.count), P(self.m_y),
                P(self.any_ok), P(self.hint_w), P(self.hint_flat), sh)
            kernels.check(err, "decomp")
            err = dlib.dtk_decomp_bound_f64(
                P(self.m_y), P(self.any_ok), P(self.lam), P(self.mu), P(v["Ws"]), P(self.E64),
                L, n_k, M, sig.e_max + 1, P(self.bound), sh)
            kernels.check(err, "decomp_bound")
        self._moe_phase(lib, sh, 0)
        if cold:
            self._round_moe(sh, self.hint_v, 3 * M, v["Ws"], v["ks"], self.inst_hint,
                            L * n_k, sig.e_max + 4, MOE_LOCAL_MOVES, self.hint_out)
            self._moe_phase(lib, sh, 1)
        if sig.has_warm:
            self._round_moe(sh, self.warm_v, 3 * M, self.warm_W, self.warm_k, self.inst_lane,
                            L, None, MOE_LOCAL_MOVES_WARM, self.warm_out)
            self._moe_phase(lib, sh, 2)

    def _moe_phase(self, lib, sh, phase: int) -> None:
        sig, v = self.sig, self.views
        rows = self.hint_out if phase == 1 else self.warm_out
        ptrs = self._keep_ptrs([
            _p(v["obj_const"]), _p(self.bound), _p(v.get("margin")), _p(self.lam), _p(self.mu),
            _p(self.tau), _p(v.get("duals")), _p(self.duals_out), _p(self.hint_w),
            _p(self.hint_flat), _p(v["rd"]), _p(self.bp64), _p(self.hint_v),
            _p(v.get("warm_kidx")), _p(v.get("warm_w")), _p(v.get("warm_n")),
            _p(v.get("warm_y")), _p(v["Ws"]), _p(v["ks"]), _p(self.warm_v), _p(self.warm_W),
            _p(self.warm_k), *map(_p, rows), *self._state_ptrs(0)])
        dims = self._keep_ptrs_int([
            sig.L, sig.cap, sig.n_k, sig.M, phase,
            int(sig.decomp_steps > 0 and not sig.has_margin), int(sig.has_warm),
            sig.e_max + 1, PACKED_ROWS * sig.M,
            *[_RD_ROWS[f] for f in ("has_gpu", "ram_minus_n", "cuda_rhs", "metal_rhs", "eb_ram",
                                    "eb_vram", "eb_metal", "ram_rhs")]])
        kernels.check(lib.dtk_bnb_seed_moe(ptrs, dims, sh), "bnb_seed")

    def _round_moe(self, sh, v, v_stride: int, W, k, inst, B: int, y_steps, moves: int,
                   out) -> None:
        """K2's MoE mode on plan buffers (float64 hint and warm rows, the
        LP's float32 points)."""
        from ..kernels.build import library

        P, O = kernels.ptr, kernels.opt_ptr
        lib = library("round_moe")
        fn = lib.dtk_round_moe_f64 if v.dtype == BDTYPE else lib.dtk_round_moe_f32
        err = fn(P(v), v_stride, P(W), P(k), P(self.views["rd"]), P(self.E64), P(inst),
                 self.sig.M, B, -1 if y_steps is None else int(y_steps), int(moves),
                 *[P(t) for t in out], O(self.tab), 0 if self.tab is None else self.tab.numel(),
                 MOE_THREADS, sh)
        kernels.check(err, "round_moe")

    def _keep_ptrs_int(self, vals) -> int:
        arr = (ctypes.c_int * len(vals))(*vals)
        self._keep = self._keep[-63:] + [arr]
        return ctypes.addressof(arr)

    def _control(self, lib, sh, init: bool = False, go: int = 0, h=None) -> None:
        """The loop's control: ``init`` on the seeded state, else after the
        round that wrote state ``go`` (the round log's row of it from the
        two states, in a diagnostics plan)."""
        sig = self.sig
        st = self.states[0]
        src = [st.active, st.node_bound, st.node_kidx, st.incumbent, st.dropped_bound,
               st.per_k_best, st.per_k_dropped] if init else [None] * 7
        log = [None] * 9
        if sig.diag:
            b, a = self.states[1 - go], self.states[go]
            log = [self.log, *([None] * 7 if init else [
                b.active, b.stat_ipm_iters, a.active, a.node_bound, a.incumbent,
                a.dropped_bound, a.stat_ipm_iters]), self.trace]
        ptrs = self._keep_ptrs([0 if init else _p(self.gos[go]), *map(_p, src),
                                _p(self.frozen), _p(self.ran), _p(self.ctl), *map(_p, log)])
        words = self.trace.numel() * self.trace.element_size() // 4 if sig.diag else 0
        dims = self._keep_ptrs_int([sig.L, sig.cap, sig.n_k, int(sig.per_k), sig.max_rounds,
                                    int(init), sig.B0, sig.Bw, words])
        err = lib.dtk_bnb_control(ptrs, dims, sig.mip_gap, 0 if h is None else h.value, sh)
        kernels.check(err, "bnb_control")

    def _round(self, data: SweepData, sh, src: int, dst: int, which: int) -> None:
        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        R = sig.L * B
        self._head(data, sh, src, which)
        if self.row_mesh:
            self._k6b(sh, which)
            self._gather(sh, which)
        elif self.node_mesh:
            # K10: each shard's rows through the LP engine, then through K2,
            # with the batches of search._node_sharded.
            per = self._launch_rows(B)
            for r0 in range(0, R, per):
                self._lp(sh, which, r0, per)
        else:
            self._lp(sh, which, 0, R)
        if self.pdhg and sig.lp_f64:
            self._cast(sh, which)
        if self.node_mesh:
            per = self._launch_rows(B)
            for r0 in range(0, R, per):
                self._k2(sh, which, r0, per)
        elif sig.moe:
            self._k2(sh, which, 0, R)
        self._tail(data, sh, src, dst, which)

    def _lp(self, sh, which: int, r0: int, n: int) -> None:
        if self.pdhg:
            self._k5(sh, which, r0, n)
        else:
            self._k1(sh, which, r0, n)

    def _k2(self, sh, which: int, r0: int, n: int) -> None:
        """K2 on the LP points of rows ``r0 .. r0 + n``: its MoE mode, or its
        dense entry (a node-mesh shard's dense rows)."""
        from ..kernels.build import library

        sig, rows = self.sig, slice(r0, r0 + n)
        v, inst = self.res[which].v[rows], self.inst_rows[which][rows]
        out = tuple(t[rows] for t in self.lp_out)
        if sig.moe:
            self._round_moe(sh, v, sig.nf, self.Wr[rows], self.kr[rows], inst, n, None,
                            MOE_LOCAL_MOVES, out)
            return
        P = kernels.ptr
        err = library("round").dtk_round_f32(
            P(v), sig.nf, P(self.Wr[rows]), P(self.kr[rows]), P(self.views["rd"]), P(inst),
            PACKED_ROWS * sig.M, sig.M, n, *[P(t) for t in out], sh)
        kernels.check(err, "round_incumbent")

    def _k6b(self, sh, which: int) -> None:
        """K6b's fused route on the plan's buffers (``ops.meshlp.
        k6b_launch``), one launch a slice of BMAX rows, as the wrapper
        slices them: shard 0 writes the round's result, shards 1..S-1 their
        replicas, every shard its dual block."""
        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        R, S, nf, f64 = sig.L * B, sig.S, sig.nf, sig.lp_f64
        lp = self.lp_in64 if f64 else self.lp_in
        out0 = (self.res64 if f64 else self.res)[which]
        chunk, n_chunks = chunking((sig.ipm_iters, sig.warm_iters)[which], PDHG_DEFAULT_CHUNK)
        itemsize = self.b_blk.element_size()
        # The root round's trace: shard 0 writes it (every shard takes the
        # same decisions); the launch holds one trace-row count for all.
        trace = self.trace if self._traced(which) else None
        trace_rows = n_chunks if trace is not None else 0

        def at(t, r):
            return None if t is None else t[r:].data_ptr()

        for e0 in range(0, R, _pdhg.BMAX):
            Bs = min(_pdhg.BMAX, R - e0)
            ptrs, ints = [], []
            for s in range(S):
                k = self.k6b[s]
                if self.elem:
                    nnz = sig.blk_nnz[s]
                    a = self.blk_vals.data_ptr() + (self.blk_off[s] + e0 * nnz) * itemsize
                    a_t = self.blk_index[s].data_ptr()
                else:
                    nnz, a, a_t = 0, self.A_blk[s].data_ptr(), self.At_blk[s].data_ptr()
                o, r = (out0, e0) if s == 0 else (k["out"], 0)
                ptrs.append([
                    a, a_t, at(self.b_blk[s], e0), at(lp["c"], e0), at(lp["l"], e0),
                    at(lp["u"], e0), at(lp["wv"], e0), at(self.wy_blk[s], e0),
                    at(self.lp_in["wok"], e0), at(self.lp_in["skip"], e0), k["ws"].data_ptr(),
                    k["part"].data_ptr(), None, k["part64"].data_ptr(), None,
                    k["sq"].data_ptr(), None, k["srp"].data_ptr(), None, k["sby"].data_ptr(),
                    None, k["s64"].data_ptr(), None, k["done"].data_ptr(),
                    at(o.v, r), at(o.bound, r), at(o.obj, r), at(o.rp_norm, r),
                    at(o.rd_norm, r), at(o.mu, r), at(o.converged, r), at(o.reduced, r),
                    at(self.y_blk[s], e0), at(o.z_dual, r), at(o.f_dual, r),
                    at(o.iters_run, r), at(trace, e0) if s == 0 else None])
                ints.append([Bs, sig.ms, nf, chunk, n_chunks, trace_rows, sig.Gs, 0, nnz])
            _meshlp.k6b_launch(self.elem, f64, ptrs, ints, [k["ws"].numel() for k in self.k6b],
                               _default_tol_pdhg(self.lp_dtype), sig.restart_tol, True, sh)

    def _gather(self, sh, which: int) -> None:
        """The dual blocks into the round's result in full coordinates
        (``bnb_gather_kernel``; before the float64 cast, which reads them)."""
        from ..kernels.build import library

        sig = self.sig
        R = sig.L * (sig.B0, sig.Bw)[which]
        y = (self.res64 if sig.lp_f64 else self.res)[which].y_dual
        ptrs = self._keep_ptrs([_p(self.y_blk), _p(y)])
        dims = self._keep_ptrs_int([R, sig.m, sig.S, sig.ms, self.y_blk.shape[1],
                                    int(sig.lp_f64)])
        kernels.check(library("bnb_loop").dtk_bnb_gather(ptrs, dims, sh), "bnb_gather")

    def _head(self, data: SweepData, sh, src: int, which: int) -> None:
        from ..kernels.build import library

        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        st, lp = self.states[src], dict(self.lp_in)
        vals = self.blk_vals if self.row_mesh else (
            self.val_rows[which] if self.per_node else None)
        moe = [None] * 8
        if sig.moe:
            A_rows = None if self.A_rows is None else self.A_rows[which]
            moe = [data.gky, self.gky_pos, A_rows, None if sig.lp_f64 else vals, data.Ws,
                   data.ks, self.Wr, self.kr]
        elif self.node_mesh:
            moe = [None] * 4 + [data.Ws, data.ks, self.Wr, self.kr]
        lp64 = [None] * 7
        if sig.lp_f64:
            lp64 = [self.lp_in64[k] for k in ("b", "c", "l", "u", "wv", "wy")] + [
                vals if sig.moe else None]
        mesh = [0, 0, 0]
        if self.row_mesh:
            # b and the warm y into the row blocks, in the iterate dtype.
            if sig.lp_f64:
                lp64[0], lp64[5] = self.b_blk, self.wy_blk
            else:
                lp["b"], lp["wy"] = self.b_blk, self.wy_blk
            mesh = [sig.S, sig.ms, self.b_blk.shape[1]]
        head = self._keep_ptrs([
            _p(st.node_lo), _p(st.node_hi), _p(st.node_kidx), _p(st.active), _p(st.node_v),
            _p(st.node_y), _p(st.node_z), _p(st.node_f), _p(st.node_warm), _p(self.frozen),
            _p(data.b_k), _p(data.c_k), *[_p(lp[k]) for k in ("b", "c", "l", "u", "wv", "wy",
                                                               "wz", "wf", "wok", "skip")],
            *map(_p, moe), *map(_p, lp64), _p(self.gky_mesh if self.row_mesh else None)])
        hdims = self._keep_ptrs_int([sig.L, B, sig.cap, sig.nf, sig.m, sig.n_k, int(sig.moe),
                                     sig.M, sig.nnz, int(self.pdhg), int(sig.lp_f64), *mesh,
                                     int(self.node_mesh and not sig.moe)])
        kernels.check(library("bnb_loop").dtk_bnb_head(head, hdims, sh), "bnb_head")

    def _k1(self, sh, which: int, r0: int = 0, R: Optional[int] = None) -> None:
        """K1 on the plan's buffers, rows ``r0 .. r0 + R`` of the round (all
        of them when R is None)."""
        from ..kernels.build import library

        sig = self.sig
        R = sig.L * (sig.B0, sig.Bw)[which] if R is None else R
        rows = slice(r0, r0 + R)
        lp = {k: t[rows] for k, t in self.lp_in.items()}
        iters, chunk = ((sig.ipm_iters, sig.root_chunk), (sig.warm_iters, IPM_DEFAULT_CHUNK))[which]
        chunk, n_chunks = chunking(iters, chunk)
        res = IPMResult(*(None if t is None else t[rows] for t in self.res[which]))
        A = self._lp_A(which) if not self.per_node else self._lp_A(which)[rows]
        vals = self.val_rows[which][rows] if self.per_node else self.vals
        P, O = kernels.ptr, kernels.opt_ptr
        err = library("ipm").dtk_ipm_f32(
            P(A), sig.m * sig.nf if self.per_node else 0, P(self.index), sig.nnz, sig.nent,
            sig.ncontrib, P(vals), sig.nnz if self.per_node else 0, P(lp["b"]), P(lp["c"]),
            P(lp["l"]), P(lp["u"]), P(lp["wv"]), P(lp["wy"]), P(lp["wz"]), P(lp["wf"]),
            P(lp["wok"]), P(lp["skip"]), R, sig.m, sig.nf, chunk, n_chunks,
            float(_default_tol(DTYPE)), float(_default_reg(DTYPE)), O(self.ws), O(self.vec_ws),
            P(res.v), P(res.bound), P(res.obj), P(res.rp_norm), P(res.rd_norm), P(res.mu),
            P(res.converged), P(res.reduced), P(res.y_dual), P(res.z_dual), P(res.f_dual),
            P(res.iters_run), O(self.trace[rows] if self._traced(which) else None), n_chunks,
            IPM_THREADS, sh,
        )
        kernels.check(err, "ipm")

    def _k5(self, sh, which: int, r0: int = 0, R: Optional[int] = None) -> None:
        """K5 on the plan's buffers, on the route the signature fixed, rows
        ``r0 .. r0 + R`` of the round (all of them when R is None)."""
        sig = self.sig
        R = sig.L * (sig.B0, sig.Bw)[which] if R is None else R
        sl = slice(r0, r0 + R)
        rows = {k: (IPMResult(*(None if t is None else t[sl] for t in v)) if k == "out"
                    else v[sl]) for k, v in self.k5_rows[which].items()}
        chunk, n_chunks = chunking((sig.ipm_iters, sig.warm_iters)[which], PDHG_DEFAULT_CHUNK)
        k5_launch(sig.route, sig.C, self.k5_buf, sig.smem, self.k5_ws, self.k5_ws_sizes[which],
                  self.k5_G, self.index, sig.nnz, rows["vals"],
                  sig.nnz if self.per_node else 0, rows["b"], rows["c"], rows["l"], rows["u"],
                  rows["wv"], rows["wy"], rows["wok"], rows["skip"], rows["out"], chunk,
                  n_chunks, _default_tol_pdhg(self.lp_dtype), sig.restart_tol, sh)

    def _cast(self, sh, which: int) -> None:
        """A float64 round's result into the float32 result (``search.
        cast_lp_result``)."""
        from ..kernels.build import library

        sig = self.sig
        r64, r = self.res64[which], self.res[which]
        fields = ("v", "y_dual", "z_dual", "f_dual", "obj", "rp_norm", "rd_norm", "mu")
        ptrs = self._keep_ptrs([_p(getattr(r64, f)) for f in fields]
                               + [_p(getattr(r, f)) for f in fields] + [_p(r.reduced)])
        dims = self._keep_ptrs_int([r.v.shape[0], sig.nf, sig.m])
        kernels.check(library("bnb_loop").dtk_bnb_cast(ptrs, dims, sh), "bnb_cast")

    def _tail(self, data: SweepData, sh, src: int, dst: int, which: int) -> None:
        """The round tail, state ``src`` -> buffer ``dst`` (a MoE round's
        rows pre-rounded by K2's MoE mode)."""
        from ..kernels.build import library

        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        st, res = self.states[src], self.res[which]
        pre = sig.moe or self.node_mesh
        rd = (None,) * 3 if pre else (data.Ws, data.ks, data.rd_packed)
        rows = (*self.lp_out, None)[:4] if pre else (None,) * 4
        ins = [res.v, res.reduced, res.y_dual, res.z_dual, res.f_dual, res.bound, res.iters_run,
               *rd, *rows, data.int_mask, data.obj_const, self.frozen,
               *[getattr(st, f) for f in _TAIL_STATE]]
        base = self.bufs[dst].data_ptr()
        tail = self._keep_ptrs([_p(t) for t in ins] + [
            0 if o is None else base + o for o in self.tail_offsets] + [base + self.tail_ws_off])
        tdims = self._keep_ptrs_int([sig.L, B, sig.cap, sig.nf, sig.m, sig.M, sig.n_k, int(pre),
                                     int(sig.moe), 0, 1 if pre else sig.L,
                                     0 if pre else PACKED_ROWS * sig.M, int(sig.per_k)])
        err = library("round_tail").dtk_round_tail(tail, tdims, float(sig.mip_gap), sh)
        kernels.check(err, "round_tail")

    def _answer(self, lib, sh) -> None:
        sig, v = self.sig, self.views
        r0 = self.res[0]
        rw = [v.get(k) for k in ("rw_ok", "rw_v", "rw_y", "rw_z", "rw_f")]
        ptrs = self._keep_ptrs([*self._state_ptrs(1), _p(self.ran), _p(r0.v), _p(r0.y_dual),
                                _p(r0.z_dual), _p(r0.f_dual), *map(_p, rw), _p(self.answer),
                                _p(self.duals_out if sig.moe else None),
                                _p(self.m_y if sig.want_my else None), _p(self.log),
                                _p(self.trace)])
        dims = self._keep_ptrs_int([sig.L, sig.cap, sig.nf, sig.m, sig.M, sig.n_k,
                                    int(sig.per_k), sig.B0, self.alay.width,
                                    int(sig.has_root_warm),
                                    3 * sig.n_k + sig.n_k * sig.M if sig.moe else 0,
                                    self.alay.my_size, self.alay.conv_rows, sig.trace_rows,
                                    int(sig.lp_f64)])
        kernels.check(lib.dtk_bnb_answer(ptrs, dims, sh), "bnb_answer")


def _ins_rows(ins, rows: slice):
    """The round inputs of ``rows`` (a shard's rows of a node-mesh round)."""
    return ins._replace(kidx=ins.kidx[rows], lane=ins.lane[rows], b=ins.b[rows],
                        c=ins.c[rows], lo=ins.lo[rows], hi=ins.hi[rows],
                        warm=type(ins.warm)(*(t[rows] for t in ins.warm)),
                        skip=ins.skip[rows])


def _on_device(dev):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _stream_handle(dev) -> ctypes.c_void_p:
    return kernels.stream_handle(dev) if dev.type == "cuda" else ctypes.c_void_p(0)


def _copy_state(dst: SearchState, src: SearchState) -> None:
    for a, b in zip(dst, src):
        if a.data_ptr() != b.data_ptr():
            a.copy_(b)


def control_reference(plan: LoopPlan, init: bool = False, state: Optional[SearchState] = None,
                      go: Optional[torch.Tensor] = None) -> bool:
    """Plain version of the loop's control (``bnb_control_kernel``) on the
    plan's ``frozen``, ``ran`` and counters: ``init`` tests each lane of the
    seeded ``state`` as ``run_bnb_loop`` does (a node active and no
    certificate, its go test); after a round, the tail's ``go`` flags (one
    of the plan's ``gos``: the state the round wrote) and the round count
    against ``max_rounds`` decide the next round. A diagnostics plan's
    control zeroes the log and the trace at init and writes the row of each
    round that ran (``search.round_row`` on the two states). Returns whether
    the loop goes on."""
    sig = plan.sig
    if init:
        if sig.diag:
            plan.log.zero_()
            plan.trace.zero_()
        settled = certified_per_k if sig.per_k else certified
        g = state.active.any(-1) & ~settled(state, sig.mip_gap)
        if sig.max_rounds < 1:
            g = torch.zeros_like(g)
        run = bool(g.any())
        plan.ran.copy_(g)
        plan.frozen.copy_(~(g & run))
        plan.ctl[0] = 0
        plan.ctl[1] = 0 if run else 1
        return run
    stopped = bool(plan.ctl[1])
    r = int(plan.ctl[0])
    if sig.diag and not stopped and r < sig.max_rounds:
        dst = 0 if go is plan.gos[0] else 1
        plan.log[:, r] = round_row(plan.states[1 - dst], plan.states[dst],
                                   sig.B0 if r == 0 else sig.Bw, ~plan.frozen)
    nxt = r + 1
    run = (not stopped) and bool(go.any()) and nxt < sig.max_rounds
    if not stopped:
        plan.ctl[0] = nxt
    if not run:
        plan.ctl[1] = 1
    plan.frozen.copy_(~(go & run))
    return run


def answer_rows(state: SearchState, root_iters, n_k: int, per_k: bool, duals=None,
                raw_bounds=None, extra=()) -> torch.Tensor:
    """The (L, width) float64 answer of a searched state: the head (the
    reference's, less its dropped bound), the duals and raw root bounds, the
    per-k block, the root round's iterates ``root_iters`` (ok, v, y, z, f,
    (L, >= n_k, ...)), then ``extra`` (L, ...) tensors: the answer kernel's
    plain version, and the host loop's answer."""
    L = state.incumbent.shape[0]
    parts = [
        torch.stack([
            state.incumbent, best_bound(state), state.inc_kidx.to(BDTYPE),
            state.stat_ipm_iters, state.stat_rounds,
        ], dim=1),
        state.inc_w, state.inc_n, state.inc_y, state.per_k_best,
    ]
    if duals is not None:
        parts += [t.reshape(L, -1).to(BDTYPE) for t in duals] + [raw_bounds.to(BDTYPE)]
    if per_k:
        parts += [state.per_k_w.reshape(L, -1), state.per_k_n.reshape(L, -1),
                  state.per_k_y.reshape(L, -1), per_k_bound(state)]
    parts += [t[:, :n_k].to(BDTYPE).reshape(L, -1) for t in root_iters]
    parts += [t.to(BDTYPE).reshape(L, -1) for t in extra]
    return torch.cat(parts, dim=1)


def answer_reference(plan: LoopPlan, state: SearchState, moe=None) -> torch.Tensor:
    """Plain version of ``bnb_answer_kernel``: the root iterates are the
    root round's LP result in the lanes that ran it, else the carried-in
    ones (the seeded state's, as ``run_bnb_loop`` keeps them); ``moe`` =
    (duals, raw bounds, m_y) of a MoE seed (m_y after the root iterates
    where the plan asks for it); a diagnostics plan's log and the first n_k
    roots' trace (float32; zeros in a lane that skipped the root round) at
    the end."""
    sig, v = plan.sig, plan.views
    L, n_k, dev = sig.L, sig.n_k, plan.dev
    r0 = plan.res[0]
    ran = (r0.v.new_ones((L, sig.B0), dtype=torch.bool),
           *(t.reshape(L, sig.B0, -1) for t in (r0.v, r0.y_dual, r0.z_dual, r0.f_dual)))
    if sig.has_root_warm:
        carried = (v["rw_ok"], v["rw_v"], v["rw_y"], v["rw_z"], v["rw_f"])
    else:
        carried = (torch.zeros((L, n_k), dtype=torch.bool, device=dev),
                   torch.zeros((L, n_k, sig.nf), dtype=DTYPE, device=dev),
                   torch.zeros((L, n_k, sig.m), dtype=DTYPE, device=dev),
                   torch.zeros((L, n_k, sig.nf), dtype=DTYPE, device=dev),
                   torch.zeros((L, n_k, sig.nf), dtype=DTYPE, device=dev))
    m1 = plan.ran[:, None]
    root = tuple(torch.where(m1 if a.dim() == 2 else m1[..., None], a[:, :n_k], b[:, :n_k])
                 for a, b in zip(ran, carried))
    diag = []
    if sig.diag:
        tr = plan.trace.reshape(L, sig.B0, sig.trace_rows, TRACE_COLS)[:, :n_k].to(DTYPE)
        diag = [plan.log, torch.where(m1[..., None, None], tr, torch.zeros_like(tr))]
    if moe is None:
        return answer_rows(state, root, n_k, sig.per_k, extra=diag)
    duals, raw, m_y = moe
    return answer_rows(state, root, n_k, sig.per_k, duals, raw,
                       ([m_y] if sig.want_my else []) + diag)


def count_graph_launches(sig: PlanSig, ans: np.ndarray) -> None:
    """The kernels one graph launch ran, from the answer: the seed (for a
    MoE sweep K7's launches, its folds, the MoE seed's phases and K2's hint
    and warm rows), the answer, and a head, K1 or K5 (a node mesh: one a
    shard; a row mesh: K6b a slice and the gather; in float64 the cast),
    (MoE, node mesh) K2's LP rows (a node mesh: a launch a shard), a round
    tail and a control each round (the root, then two a pass of the WHILE
    body; the rounds run are the most any lane ran), one more control at
    the start. A diagnostics plan's root LP counts as the traced launch
    (``ipm_trace``, ``pdhg_trace``; K6b under its own names, traced or
    not)."""
    R = int(np.max(ans[:, 4])) if ans.size else 0
    rounds = 1 + 2 * math.ceil(max(R - 1, 0) / 2)
    kernels.LAUNCHES["bnb_graph"] += 1
    kernels.count_launch("bnb_seed")
    kernels.count_launch("bnb_answer")
    lanes = "_lanes" if sig.L > 1 else ""
    if sig.moe:
        cold = sig.decomp_steps > 0 and not sig.has_margin
        if not sig.has_margin:
            if cold:
                kernels.count_launch("decomp" + lanes, "ascent")
            kernels.count_launch("decomp_theta")
            kernels.count_launch("decomp" + lanes, "eval64")
            kernels.count_launch("decomp_bound")
        for _ in range(1 + int(cold) + int(sig.has_warm)):
            kernels.count_launch("bnb_seed")
        for _ in range(int(cold) + int(sig.has_warm)):
            kernels.count_launch("round_moe" + lanes)
    per_node = sig.a_lanes or sig.moe
    shards = sig.S if sig.mesh == "node" else 1
    for r in range(rounds):
        B = sig.B0 if r == 0 else sig.Bw
        traced = r == 0 and sig.diag
        kernels.count_launch("bnb_head")
        R = sig.L * B
        if sig.mesh == "row":
            # Under K6b's wrapper's names and shape keys: one fused launch a
            # slice of BMAX rows; then the gather of the dual blocks.
            name = "pdhg_sharded_elem" if sig.blk_nnz else "pdhg_sharded"
            shape = f"B={R} m={sig.m} n={sig.nf} S={sig.S}" + (
                f" per-element A nnz={sum(sig.blk_nnz)}" if sig.blk_nnz else "") + " route=fused"
            for _ in range(-(-R // _pdhg.BMAX)):
                kernels.count_launch(name, shape)
            kernels.count_launch("bnb_gather")
        elif sig.engine == "pdhg":
            # Under the wrapper's names and shape keys: one cluster launch,
            # or one grid launch a slice of BMAX rows (a node mesh: a shard).
            per = R // shards
            shape = k5_shape(per, sig.m, sig.nf, not per_node, sig.nnz, sig.route, sig.C)
            for _ in range(shards * (1 if sig.route == "cluster" else -(-per // _pdhg.BMAX))):
                kernels.count_launch(k5_name(not per_node, traced), shape)
        else:
            for _ in range(shards):
                kernels.count_launch("ipm_trace" if traced else "ipm",
                                     f"B={R // shards} m={sig.m} n={sig.nf}"
                                     f"{' per-node A' if per_node else ''}")
        if sig.engine == "pdhg" and sig.lp_f64:
            kernels.count_launch("bnb_cast")
        for _ in range(shards if (sig.moe or sig.mesh == "node") else 0):
            kernels.count_launch("round_moe" + lanes if sig.moe else "round_incumbent" + lanes)
        kernels.count_launch("round_tail" + lanes)
        kernels.count_launch("bnb_control")
    kernels.count_launch("bnb_control")


_PLANS: "OrderedDict[PlanSig, list]" = OrderedDict()
# The LRU holds this many signatures besides the pinned ones.
_PLANS_CAP = 16
_PLANS_LOCK = threading.Lock()
# Signatures whose plans the LRU never evicts (see pinning_plans).
_PINNED: set = set()
_PIN = threading.local()


@contextlib.contextmanager
def pinning_plans():
    """Pin every plan acquired on this thread inside the block.

    The gateway's ``warm_combine`` solves each batch shape its committed
    bucket policy can reach inside this block: the plans (and on the card
    their captured graphs) of that finite set then survive whatever else
    the process solves, so the serving phase captures no graph. Pinned
    signatures do not count against the LRU's cap."""
    prev = getattr(_PIN, "on", False)
    _PIN.on = True
    try:
        yield
    finally:
        _PIN.on = prev


def acquire_plan(sig: PlanSig) -> LoopPlan:
    """A free plan of ``sig`` (built on first use), marked busy until
    :func:`release_plan`."""
    pin = getattr(_PIN, "on", False)
    with _PLANS_LOCK:
        if pin:
            _PINNED.add(sig)
        plans = _PLANS.get(sig)
        if plans is not None:
            _PLANS.move_to_end(sig)
            for p in plans:
                if not p.busy:
                    p.busy = True
                    return p
    plan = LoopPlan(sig)
    plan.busy = True
    with _PLANS_LOCK:
        PLANS_BUILT[sig] = PLANS_BUILT.get(sig, 0) + 1
        _PLANS.setdefault(sig, []).append(plan)
        _PLANS.move_to_end(sig)
        while sum(1 for s in _PLANS if s not in _PINNED) > _PLANS_CAP:
            old = next(s for s in _PLANS if s not in _PINNED)
            if any(p.busy for p in _PLANS[old]):
                break
            del _PLANS[old]
    return plan


def release_plan(plan: Optional[LoopPlan]) -> None:
    if plan is not None:
        plan.busy = False


def clear_plans() -> None:
    """Drop every idle plan and its graph (tests; device teardown)."""
    with _PLANS_LOCK:
        for sig in list(_PLANS):
            _PLANS[sig] = [p for p in _PLANS[sig] if p.busy]
            if not _PLANS[sig]:
                del _PLANS[sig]
        _PINNED.intersection_update(_PLANS)
