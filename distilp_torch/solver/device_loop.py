"""The branch-and-bound of a dense IPM sweep as one CUDA graph.

The reference runs a sweep as one device program (``distilp_tpu/solver/
backend_jax.py::_solve_packed_impl`` :2100 with ``_run_bnb_loop`` :2732):
the root state, the warm incumbent, the root round, a ``lax.while_loop``
whose condition, the gap test, runs on the device, and the answer. Here a
:class:`LoopPlan` owns every buffer of a solve of one signature (shapes,
budgets, ``mip_gap``, ``max_rounds``, which optional inputs it has) and, on
the card, one CUDA graph over them, captured once (``bnb_loop_kernel.cu``):

    seed -> init -> root round (state A -> B)
         -> WHILE { round B -> A, round A -> B } -> answer

a round being the head (the LP's inputs straight from the state), K1 on the
plan's buffers, the round tail into the other state buffer, and the loop's
control, which sets the WHILE node's condition from the device. A solve is
then one upload of the dynamic blob (``packed``), one graph launch and one
read of the answer. On CPU tensors the same plan runs the plain versions
(``search.root_state``/``seed_warm``, ``search.round_inputs``, K1's and the
round tail's plain versions, :func:`control_reference`,
:func:`answer_reference`), a Python ``while`` standing in for the
conditional node.

The route is chosen by the configuration (:func:`loop_route`): the graph
for dense sweeps on the IPM engine, whatever the lanes (one A or an A each)
and per-k or not; MoE rounds (K2 MoE on a per-node A), the PDHG engine, the
row mesh and the convergence log keep ``search.run_bnb_loop``, the host
loop. ``kernels.SHAPES["bnb_graph"]`` counts the route of every search. A
failed capture, instantiation or launch raises: nothing falls back to the
host loop, which stays only as the private :func:`host_loop` for the card's
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
    THREADS as IPM_THREADS,
    IPMResult,
    LPBatch,
    _default_reg,
    _default_tol,
    chunking,
    ipm_solve_batch,
    ipm_workspace,
)
from . import packed
from .rounding import PACKED_ROWS
from .search import (
    BDTYPE,
    DTYPE,
    TAIL_SMEM_LIMIT,
    SearchState,
    SweepData,
    _lanes_of,
    best_bound,
    certified,
    certified_per_k,
    per_k_bound,
    root_state,
    round_inputs,
    round_tail,
    seed_warm,
    tail_layout,
    tail_views,
)
from .standard_form import MOE_LOCAL_MOVES_WARM

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


def loop_route(moe: bool, engine: str, row_mesh, collect_rounds: bool) -> Tuple[str, str]:
    """("graph" | "host", why) of a search's configuration."""
    if moe:
        return "host", "moe"
    if engine != "ipm":
        return "host", engine
    if row_mesh is not None and row_mesh.size > 1:
        return "host", "row_mesh"
    if collect_rounds:
        return "host", "convergence"
    return "graph", "dense_ipm"


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


# The compile ledger's view of a signature: a capture with a new value of
# one of these fields is a static-argument flip (the engine's route, the
# iteration budgets, the per-k mode, the optional warm inputs); with new
# values of the others only, a shape-bucket change.
_STATIC_FIELDS = ("device", "per_k", "ipm_iters", "root_chunk", "warm_iters", "mip_gap",
                  "max_rounds", "has_warm", "has_root_warm", "a_lanes")
_SHAPE_FIELDS = tuple(f for f in PlanSig._fields if f not in _STATIC_FIELDS)


def ledger_signatures(sig: PlanSig) -> Tuple[str, str]:
    """(static signature, shape signature) of a plan for the compile
    ledger (``obs.compile_ledger``)."""
    return (",".join(f"{f}={getattr(sig, f)!r}" for f in _STATIC_FIELDS),
            ",".join(f"{f}={getattr(sig, f)}" for f in _SHAPE_FIELDS))


def plan_sig(dev, L, cap, n_k, beam, m, nf, M, per_k, ipm_iters, ipm_warm_iters,
             root_warm_chunk, mip_gap, max_rounds, has_warm, has_root_warm, entry) -> PlanSig:
    sp = entry.sparsity
    return PlanSig(
        device=str(torch.device(dev)), L=L, cap=cap, B0=min(cap, n_k),
        Bw=cap if beam is None else min(beam, cap), m=m, nf=nf, M=M, n_k=n_k, per_k=bool(per_k),
        ipm_iters=int(ipm_iters),
        root_chunk=IPM_DEFAULT_CHUNK if root_warm_chunk else int(ipm_iters),
        warm_iters=int(ipm_iters if ipm_warm_iters is None else ipm_warm_iters),
        mip_gap=float(mip_gap), max_rounds=int(max_rounds), has_warm=bool(has_warm),
        has_root_warm=bool(has_root_warm), a_lanes=entry.A.dim() == 3, nnz=sp.nnz,
        nent=sp.nent, ncontrib=sp.ncontrib, index_len=int(sp.index.numel()),
    )


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
        self.layout = packed.dyn_layout(L, n_k, m, nf, M, False, sig.has_warm,
                                        sig.has_root_warm, False)
        cuda = dev.type == "cuda"
        self.pinned = torch.empty(self.layout.nbytes, dtype=torch.uint8, pin_memory=cuda)
        self.blob = torch.empty(self.layout.nbytes, dtype=torch.uint8, device=dev)
        self.views = packed.dyn_views(self.blob, self.layout)
        self.rd_views = packed.rounding_views(self.views)
        # K1's A and its values on the structure (a shared A, or each row's
        # lane's for the root and the warm rows), loaded from the static
        # entry when it changes.
        self.index = torch.empty(sig.index_len, dtype=torch.int32, device=dev)
        if sig.a_lanes:
            self.A_rows = [torch.empty((L * B, m, nf), dtype=f32, device=dev) for B in (B0, Bw)]
            self.val_rows = [torch.empty((L * B, sig.nnz), dtype=f32, device=dev)
                             for B in (B0, Bw)]
        else:
            self.A = torch.empty((m, nf), dtype=f32, device=dev)
            self.vals = torch.empty(sig.nnz, dtype=f32, device=dev)
        self.loaded = None
        # Two state buffers in the round tail's layout, its workspace after.
        views, offsets, end = tail_layout(L, cap, nf, m, M, n_k, sig.per_k)
        self.tail_offsets, self.tail_ws_off = offsets, end
        ws = 0
        if cuda:
            from ..kernels.build import library

            lib = library("round_tail")
            for B in (B0, Bw):
                need = int(lib.dtk_round_tail_smem_bytes(B, cap, M, 0, n_k, int(sig.per_k)))
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
        self.lp_in = dict(
            b=torch.empty((R, m), dtype=f32, device=dev), c=torch.empty((R, nf), dtype=f32, device=dev),
            l=torch.empty((R, nf), dtype=f32, device=dev), u=torch.empty((R, nf), dtype=f32, device=dev),
            wv=torch.empty((R, nf), dtype=f32, device=dev), wy=torch.empty((R, m), dtype=f32, device=dev),
            wz=torch.empty((R, nf), dtype=f32, device=dev), wf=torch.empty((R, nf), dtype=f32, device=dev),
            wok=torch.empty(R, dtype=b8, device=dev), skip=torch.empty(R, dtype=b8, device=dev))
        self.res = [self._lp_out(L * B) for B in (B0, Bw)]
        self.ws = self.vec_ws = None
        if cuda:
            need = [ipm_workspace(L * B, m, nf, f32, dev)[1:] for B in (B0, Bw)]
            vec, fac = max(v for v, _ in need), max(f for _, f in need)
            self.ws = torch.empty(fac // 4, dtype=f32, device=dev) if fac else None
            self.vec_ws = torch.empty(vec // 4, dtype=f32, device=dev) if vec else None
        self.frozen = torch.ones(L, dtype=b8, device=dev)
        self.ran = torch.zeros(L, dtype=b8, device=dev)
        self.ctl = torch.zeros(2, dtype=torch.int32, device=dev)
        self.alay = packed.AnswerLayout(M, n_k, m, nf, False, sig.per_k)
        self.answer = torch.empty((L, self.alay.width), dtype=f64, device=dev)
        self.graph = ctypes.c_void_p(None)
        self.handle = ctypes.c_ulonglong(0)
        self.busy = False
        self._keep: list = []
        _memory.note_plan(_memory.device_bytes(vars(self), dev) if cuda else None)

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
        """The sweep's data as views of the plan's blob and the entry."""
        v = self.views
        return SweepData(
            A=entry.A, b_k=v["b_k"], c_k=v["c_k"], int_mask=v["int_mask"], ks=v["ks"],
            Ws=v["Ws"], obj_const=v["obj_const"], rd=self.rd_views,
            rd_packed=v["rd"], A_sparsity=entry.sparsity, A_k1_values=entry.values,
            A_checked=True,
        )

    def load_static(self, entry) -> None:
        """K1's A, structure and values from ``entry`` into the plan's
        buffers, when another entry was loaded (copies on the card)."""
        if self.loaded is entry:
            return
        self.index.copy_(entry.sparsity.index)
        if self.sig.a_lanes:
            for i, B in enumerate((self.sig.B0, self.sig.Bw)):
                lanes = _lanes_of(self.sig.L, B, self.dev)
                self.A_rows[i].copy_(entry.A[lanes])
                self.val_rows[i].copy_(entry.values[lanes])
        else:
            self.A.copy_(entry.A)
            self.vals.copy_(entry.values)
        self.loaded = entry

    def _lp_A(self, i: int) -> torch.Tensor:
        return self.A_rows[i] if self.sig.a_lanes else self.A

    # -------------------------------------------------------- plain (CPU)

    def run_plain(self, entry, warm=None, root_warm=None,
                  seeded: Optional[SearchState] = None) -> np.ndarray:
        """The plan's loop with the plain versions: the answer (L, width).
        ``seeded`` replaces the seed's state (tests)."""
        sig, v = self.sig, self.views
        self.load_static(entry)
        data = self.data(entry)
        if seeded is None:
            seeded = root_state(v["lo_k"], v["hi_k"], sig.M, sig.cap, sig.m, root_warm)
            if warm is not None:
                seeded = seed_warm(seeded, data, warm, False, MOE_LOCAL_MOVES_WARM)
        _copy_state(self.states[0], seeded)
        control_reference(self, init=True, state=self.states[0])
        self._round_plain(data, 0, 1, 0)
        go = control_reference(self, go=self.gos[1])
        while go:
            self._round_plain(data, 1, 0, 1)
            control_reference(self, go=self.gos[0])
            self._round_plain(data, 0, 1, 1)
            go = control_reference(self, go=self.gos[1])
        self.answer.copy_(answer_reference(self, self.states[1]))
        return self.answer.numpy().copy()

    def _round_plain(self, data: SweepData, src: int, dst: int, which: int) -> None:
        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        state = self.states[src]
        ins = round_inputs(data, state, B, self.frozen)
        iters, chunk = ((sig.ipm_iters, sig.root_chunk), (sig.warm_iters, IPM_DEFAULT_CHUNK))[which]
        res = ipm_solve_batch(
            LPBatch(A=self._lp_A(which), b=ins.b, c=ins.c, l=ins.lo, u=ins.hi),
            iters=iters, warm=ins.warm, skip=ins.skip, chunk=chunk, sparsity=data.A_sparsity,
            _checked=True,
        )
        keep = self.res[which]
        for f in _RES_FIELDS:
            getattr(keep, f).copy_(getattr(res, f))
        out, go = round_tail(data, state, keep, sig.mip_gap, B, None, self.frozen, sig.per_k)
        _copy_state(self.states[dst], out)
        self.gos[dst].copy_(go)

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
        sig, v = self.sig, self.views
        rw = [v.get(k) for k in ("rw_ok", "rw_v", "rw_y", "rw_z", "rw_f")]
        wk = [v.get(k) for k in ("warm_kidx", "warm_w", "warm_n")]
        ptrs = self._keep_ptrs([_p(v["lo_k"]), _p(v["hi_k"]), *map(_p, rw), *map(_p, wk),
                                _p(v["Ws"]), _p(v["ks"]), _p(v["rd"]), _p(v["obj_const"]),
                                *self._state_ptrs(0)])
        dims = self._keep_ptrs_int([sig.L, sig.cap, sig.nf, sig.m, sig.M, sig.n_k,
                                    int(sig.has_root_warm), int(sig.has_warm),
                                    PACKED_ROWS * sig.M])
        kernels.check(lib.dtk_bnb_seed(ptrs, dims, sh), "bnb_seed")

    def _keep_ptrs_int(self, vals) -> int:
        arr = (ctypes.c_int * len(vals))(*vals)
        self._keep = self._keep[-63:] + [arr]
        return ctypes.addressof(arr)

    def _control(self, lib, sh, init: bool = False, go: int = 0, h=None) -> None:
        sig = self.sig
        st = self.states[0]
        src = [st.active, st.node_bound, st.node_kidx, st.incumbent, st.dropped_bound,
               st.per_k_best, st.per_k_dropped] if init else [None] * 7
        ptrs = self._keep_ptrs([0 if init else _p(self.gos[go]), *map(_p, src),
                                _p(self.frozen), _p(self.ran), _p(self.ctl)])
        dims = self._keep_ptrs_int([sig.L, sig.cap, sig.n_k, int(sig.per_k), sig.max_rounds,
                                    int(init)])
        err = lib.dtk_bnb_control(ptrs, dims, sig.mip_gap, 0 if h is None else h.value, sh)
        kernels.check(err, "bnb_control")

    def _round(self, data: SweepData, sh, src: int, dst: int, which: int) -> None:
        self._head(data, sh, src, which)
        self._k1(sh, which)
        self._tail(data, sh, src, dst, which)

    def _head(self, data: SweepData, sh, src: int, which: int) -> None:
        from ..kernels.build import library

        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        st, lp = self.states[src], self.lp_in
        head = self._keep_ptrs([
            _p(st.node_lo), _p(st.node_hi), _p(st.node_kidx), _p(st.active), _p(st.node_v),
            _p(st.node_y), _p(st.node_z), _p(st.node_f), _p(st.node_warm), _p(self.frozen),
            _p(data.b_k), _p(data.c_k), *[_p(lp[k]) for k in ("b", "c", "l", "u", "wv", "wy",
                                                               "wz", "wf", "wok", "skip")]])
        hdims = self._keep_ptrs_int([sig.L, B, sig.cap, sig.nf, sig.m, sig.n_k])
        kernels.check(library("bnb_loop").dtk_bnb_head(head, hdims, sh), "bnb_head")

    def _k1(self, sh, which: int) -> None:
        """K1 on the plan's buffers."""
        from ..kernels.build import library

        sig, lp = self.sig, self.lp_in
        B = (sig.B0, sig.Bw)[which]
        iters, chunk = ((sig.ipm_iters, sig.root_chunk), (sig.warm_iters, IPM_DEFAULT_CHUNK))[which]
        chunk, n_chunks = chunking(iters, chunk)
        res = self.res[which]
        A = self._lp_A(which)
        vals = self.val_rows[which] if sig.a_lanes else self.vals
        R = sig.L * B
        P, O = kernels.ptr, kernels.opt_ptr
        err = library("ipm").dtk_ipm_f32(
            P(A), sig.m * sig.nf if sig.a_lanes else 0, P(self.index), sig.nnz, sig.nent,
            sig.ncontrib, P(vals), sig.nnz if sig.a_lanes else 0, P(lp["b"]), P(lp["c"]),
            P(lp["l"]), P(lp["u"]), P(lp["wv"]), P(lp["wy"]), P(lp["wz"]), P(lp["wf"]),
            P(lp["wok"]), P(lp["skip"]), R, sig.m, sig.nf, chunk, n_chunks,
            float(_default_tol(DTYPE)), float(_default_reg(DTYPE)), O(self.ws), O(self.vec_ws),
            P(res.v), P(res.bound), P(res.obj), P(res.rp_norm), P(res.rd_norm), P(res.mu),
            P(res.converged), P(res.reduced), P(res.y_dual), P(res.z_dual), P(res.f_dual),
            P(res.iters_run), O(None), n_chunks, IPM_THREADS, sh,
        )
        kernels.check(err, "ipm")

    def _tail(self, data: SweepData, sh, src: int, dst: int, which: int) -> None:
        """The round tail, state ``src`` -> buffer ``dst``."""
        from ..kernels.build import library

        sig = self.sig
        B = (sig.B0, sig.Bw)[which]
        st, res = self.states[src], self.res[which]
        ins = [res.v, res.reduced, res.y_dual, res.z_dual, res.f_dual, res.bound, res.iters_run,
               data.Ws, data.ks, data.rd_packed, None, None, None, None, data.int_mask,
               data.obj_const, self.frozen, *[getattr(st, f) for f in _TAIL_STATE]]
        base = self.bufs[dst].data_ptr()
        tail = self._keep_ptrs([_p(t) for t in ins] + [
            0 if o is None else base + o for o in self.tail_offsets] + [base + self.tail_ws_off])
        tdims = self._keep_ptrs_int([sig.L, B, sig.cap, sig.nf, sig.m, sig.M, sig.n_k, 0, 0, 0,
                                     sig.L, PACKED_ROWS * sig.M, int(sig.per_k)])
        err = library("round_tail").dtk_round_tail(tail, tdims, float(sig.mip_gap), sh)
        kernels.check(err, "round_tail")

    def _answer(self, lib, sh) -> None:
        sig, v = self.sig, self.views
        r0 = self.res[0]
        rw = [v.get(k) for k in ("rw_ok", "rw_v", "rw_y", "rw_z", "rw_f")]
        ptrs = self._keep_ptrs([*self._state_ptrs(1), _p(self.ran), _p(r0.v), _p(r0.y_dual),
                                _p(r0.z_dual), _p(r0.f_dual), *map(_p, rw), _p(self.answer)])
        dims = self._keep_ptrs_int([sig.L, sig.cap, sig.nf, sig.m, sig.M, sig.n_k,
                                    int(sig.per_k), sig.B0, self.alay.width,
                                    int(sig.has_root_warm)])
        kernels.check(lib.dtk_bnb_answer(ptrs, dims, sh), "bnb_answer")


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
    certificate, its go test); after a round, the tail's ``go`` flags and
    the round count against ``max_rounds`` decide the next round. Returns
    whether the loop goes on."""
    sig = plan.sig
    if init:
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
    nxt = int(plan.ctl[0]) + 1
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


def answer_reference(plan: LoopPlan, state: SearchState) -> torch.Tensor:
    """Plain version of ``bnb_answer_kernel``: the root iterates are the
    root round's LP result in the lanes that ran it, else the carried-in
    ones (the seeded state's, as ``run_bnb_loop`` keeps them)."""
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
    return answer_rows(state, root, n_k, sig.per_k)


def count_graph_launches(sig: PlanSig, ans: np.ndarray) -> None:
    """The kernels one graph launch ran, from the answer: the seed, the
    answer, and a head, K1, a round tail and a control each round (the
    root, then two a pass of the WHILE body; the rounds run are the most
    any lane ran), one more control at the start."""
    R = int(np.max(ans[:, 4])) if ans.size else 0
    rounds = 1 + 2 * math.ceil(max(R - 1, 0) / 2)
    kernels.LAUNCHES["bnb_graph"] += 1
    kernels.count_launch("bnb_seed")
    kernels.count_launch("bnb_answer")
    tail = "round_tail_lanes" if sig.L > 1 else "round_tail"
    per_node = " per-node A" if sig.a_lanes else ""
    for r in range(rounds):
        B = sig.B0 if r == 0 else sig.Bw
        kernels.count_launch("bnb_head")
        kernels.count_launch("ipm", f"B={sig.L * B} m={sig.m} n={sig.nf}{per_node}")
        kernels.count_launch(tail)
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
