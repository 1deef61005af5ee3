"""Process-backed shard workers: one subprocess per worker, thin RPC.

The port's copy of ``distilp_tpu/gateway/procworker.py``. A
``ProcShardWorker`` IS a ``ShardWorker`` — same daemon thread, same
queue, same submit/stop/read contract — except the objects in its
``shards`` dict are ``SchedulerProxy`` instances: every scheduler method
a queued closure touches (``handle``, ``dump_state``, ``health`` …) is
forwarded over a length-prefixed RPC on a private Unix domain socket to
a child process that hosts the real ``Scheduler``. The child has its own
Python interpreter and its own CUDA context on the card, so N process
workers solve on N GILs — the scaling the thread backend cannot reach
(one GIL for every worker thread).

Why this shape and not multiprocessing:

- ``subprocess.Popen([sys.executable, "-m", …])`` gives the child a
  FRESH interpreter. ``fork`` after CUDA is initialised is undefined
  behavior (the CUDA runtime's state forks mid-flight); ``spawn`` via
  multiprocessing drags a pickled parent context we don't want. The
  child creates its CUDA context on its first solve, on the device its
  build spec names (``kwargs['device']``: CUDA unless the gateway was
  asked for the CPU). It loads the kernel libraries the parent built:
  they are keyed by the hash of their sources under the build directory
  (``kernels.build``), so a child compiles nothing, and every reply
  carries the child's count of ``nvcc`` runs so the parent can show it.
- The parent binds and listens BEFORE spawning, so the child's connect
  never races the listener; the socket lives in a mode-0700 tempdir, so
  the pickle channel is private to this uid (pickle over a socket is an
  RCE vector only if something else can write to it — nothing can).
- Framing is 8-byte big-endian length + pickle payload. One
  request/one reply, strictly serialized under the parent's RPC lock:
  the worker thread is the only steady-state caller, but control-plane
  probes (health under load) share the channel, and interleaved frames
  would corrupt it.

The RPC carries only plain data: events and ``dump_state`` blobs are
already picklable by the snapshot contract, and ``PlacementView``
results cross the wire as ``model_dump()`` dicts (rebuilt parent-side
via ``model_validate`` — the exact round trip ``dump_state`` already
proves bit-exact), so no tensor ever crosses a process boundary.
"""

from __future__ import annotations

import os
import pickle
import socket
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional

from ..sched.metrics import SchedulerMetrics
from ..utils.lockwatch import make_lock
from .worker import ShardWorker

_LEN = struct.Struct(">Q")

# Scheduler methods whose return value is a PlacementView (or None):
# converted to a wire dict child-side, rebuilt parent-side.
_VIEW_METHODS = frozenset({"handle", "handle_coalesced", "latest"})


class WorkerCrashed(Exception):
    """The child process died under (or before) an RPC.

    Deliberately a plain ``Exception`` — NOT ``RuntimeError`` (the HTTP
    ladder maps that to 409) and NOT ``EOFError`` (that means the HTTP
    *client* hung up, a 400). ``gateway/http.py`` catches this type
    explicitly and answers 503 + Retry-After: the shard is coming back.

    Carries the pending-call inventory so the supervisor (and the error
    text a caller sees) knows exactly what was in flight: the RPC op
    that died on the wire is AMBIGUOUS (it may or may not have applied
    child-side — recovery resolves it from the WAL), while the queued
    closures behind it never dispatched and simply run post-recovery.
    """

    def __init__(
        self,
        worker_id: int,
        returncode: Optional[int],
        op: Optional[str],
        queued: int,
        detail: str = "",
    ):
        self.worker_id = worker_id
        self.returncode = returncode
        self.op = op
        self.queued = queued
        msg = (
            f"process worker {worker_id} child crashed (rc={returncode}) "
            f"during op {op!r}; {queued} queued call(s) pending"
        )
        if detail:
            msg += f" [{detail}]"
        super().__init__(msg)


# -- framing (shared by both ends) ----------------------------------------


def send_frame(sock: socket.socket, obj: Any) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_frame(sock: socket.socket) -> Optional[Any]:
    """One framed object, or None on clean EOF at a frame boundary."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (n,) = _LEN.unpack(header)
    body = _recv_exact(sock, n)
    if body is None:
        raise EOFError("peer closed mid-frame")
    return pickle.loads(body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            if buf:
                # Partial bytes then EOF: a torn connection, never a
                # clean shutdown — must not parse as a (corrupt) frame.
                raise EOFError("peer closed mid-frame")
            return None
        buf += chunk
    return buf


def _view_to_wire(view) -> Optional[dict]:
    """PlacementView -> plain dict (no tensor crosses the socket)."""
    if view is None:
        return None
    if not hasattr(view, "result") or not hasattr(view, "mode"):
        # Stub schedulers (tests) return plain picklable values; only a
        # real PlacementView needs the model_dump round trip.
        return view
    return {
        "__placement_view__": 1,
        "result": view.result.model_dump(),
        "seq": view.seq,
        "fleet_seq": view.fleet_seq,
        "events_behind": view.events_behind,
        "age_s": view.age_s,
        "mode": view.mode,
        "key": tuple(view.key) if view.key is not None else None,
        "twin_p95_s": view.twin_p95_s,
        "risk_selected": view.risk_selected,
    }


def _view_from_wire(wire: Optional[dict]):
    if wire is None:
        return None
    if not (isinstance(wire, dict) and wire.get("__placement_view__")):
        return wire  # stub schedulers may return plain picklable values
    from ..solver.result import HALDAResult
    from ..sched.scheduler import PlacementView

    return PlacementView(
        result=HALDAResult.model_validate(wire["result"]),
        seq=wire["seq"],
        fleet_seq=wire["fleet_seq"],
        events_behind=wire["events_behind"],
        age_s=wire["age_s"],
        mode=wire["mode"],
        key=wire["key"],
        twin_p95_s=wire["twin_p95_s"],
        risk_selected=wire["risk_selected"],
    )


def resolve_factory(spec: str) -> Callable:
    """'package.module:callable' -> the callable (shared by both ends:
    the Gateway validates it parent-side; the child imports it to build).
    """
    mod_name, sep, attr = spec.partition(":")
    if not sep or not mod_name or not attr:
        raise ValueError(
            f"scheduler factory spec must be 'module:callable', got {spec!r}"
        )
    import importlib

    fn = getattr(importlib.import_module(mod_name), attr)
    if not callable(fn):
        raise TypeError(f"factory {spec!r} resolved to non-callable {fn!r}")
    return fn


# -- parent side ----------------------------------------------------------


class _MetricsView:
    """Read-only snapshot of a child scheduler's metrics, shaped like the
    live ``SchedulerMetrics`` surface the gateway's read closures use
    (``.counters`` mapping + ``.snapshot()``)."""

    def __init__(self, counters: dict, snapshot: dict):
        self.counters = counters
        self._snapshot = snapshot

    def snapshot(self) -> dict:
        return dict(self._snapshot)


class SchedulerProxy:
    """Parent-side stand-in for one child-hosted ``Scheduler``.

    Quacks exactly like the scheduler surface the gateway's queued
    closures touch, so ``_tick_closure``/``dump_shard``/``healthz`` run
    unchanged. Methods here are called ON the worker thread (or from
    quiescent control-plane reads); the owning worker's RPC lock
    serializes the channel either way.
    """

    def __init__(self, owner: "ProcShardWorker", key: str):
        self._owner = owner
        self._key = key

    def _call(self, method: str, *args, **kwargs):
        out = self._owner.rpc(
            {
                "op": "call",
                "key": self._key,
                "method": method,
                "args": args,
                "kwargs": kwargs,
            }
        )
        if method in _VIEW_METHODS:
            return _view_from_wire(out)
        return out

    def _retry_read(self, fn):
        """Read-only RPCs retry ONCE against a respawned child; mutating
        calls never come through here — a mutation that died on the wire
        is ambiguous, and resolving it is the WAL's job, not a retry's."""
        try:
            return fn()
        except WorkerCrashed:
            if not self._owner.ensure_recovered():
                raise
            return fn()

    # the tick surface (mutating — NEVER auto-retried)
    def handle(self, event, pressure: bool = False):
        if pressure:
            return self._call("handle", event, pressure=True)
        return self._call("handle", event)

    def handle_coalesced(self, events, pressure: bool = False):
        return self._call("handle_coalesced", events, pressure=pressure)

    def latest(self):
        return self._retry_read(lambda: self._call("latest"))

    # the snapshot chain (bit-exact blobs pass through untouched)
    def dump_state(self) -> dict:
        return self._retry_read(lambda: self._call("dump_state"))

    def load_state(self, state: dict) -> None:
        self._call("load_state", state)

    # the read surface
    def health_snapshot(self) -> dict:
        return self._retry_read(lambda: self._call("health_snapshot"))

    def metrics_snapshot(self) -> dict:
        return self._retry_read(lambda: self._call("metrics_snapshot"))

    def fleet_view(self) -> Optional[dict]:
        """The child fleet's read surface as a plain dict (seq, published
        seq, model, devices) — None when the scheduler has no fleet
        (stub factories). The facade rebuilds a FleetReadView from it."""
        return self._retry_read(
            lambda: self._owner.rpc({"op": "fleet_view", "key": self._key})
        )

    @property
    def health(self) -> str:
        return self._retry_read(
            lambda: self._owner.rpc(
                {"op": "getattr", "key": self._key, "name": "health"}
            )
        )

    @property
    def metrics(self) -> _MetricsView:
        out = self._retry_read(
            lambda: self._owner.rpc({"op": "metrics", "key": self._key})
        )
        return _MetricsView(out["counters"], out["snapshot"])

    # the control surface (autoscaler spec_k actuation)
    @property
    def spec_k(self) -> int:
        return self._retry_read(
            lambda: self._owner.rpc(
                {"op": "getattr", "key": self._key, "name": "spec_k"}
            )
        )

    @spec_k.setter
    def spec_k(self, k: int) -> None:
        self._owner.rpc(
            {"op": "setattr", "key": self._key, "name": "spec_k", "value": k}
        )

    def close(self) -> None:
        """Drop + close the child-side scheduler (idempotent, best
        effort: a dead child already closed everything the hard way)."""
        try:
            self._owner.rpc({"op": "drop", "key": self._key})
        except Exception:  # dlint: disable=DLP017 best-effort teardown: a dead child already dropped everything; the worker's stop() path counts real RPC failures
            pass


class ProcShardWorker(ShardWorker):
    """A ShardWorker whose shards live in a dedicated subprocess.

    The parent keeps the thread + queue (closures, FIFO ordering, the
    submit/stop contract, coalescing — all parent-side and unchanged);
    only the scheduler calls inside those closures cross the socket.
    Unsupported with cross-shard combine, chaos ``fault_hook`` injection
    and callable scheduler factories — the Gateway gates those off for
    this backend (each needs in-process object sharing).
    """

    def __init__(
        self,
        worker_id: int,
        metrics: SchedulerMetrics,
        *,
        python: Optional[str] = None,
        spawn_timeout_s: float = 60.0,
        compile_ledger: bool = False,
    ):
        self._sock_dir = tempfile.mkdtemp(prefix=f"distilp-pw{worker_id}-")
        self._python = python
        self._spawn_timeout_s = spawn_timeout_s
        self._compile_ledger = compile_ledger
        # Per child generation: its start (spawn to first ping, ms) and the
        # nvcc runs it reported (the kernel libraries are the parent's).
        self.child_starts_ms: list = []
        self.child_nvcc_runs: Dict[int, int] = {}
        # Bumped on every respawn; each generation gets its own socket
        # path so a straggling old child can never connect to the new
        # listener.
        self._generation = 0
        self._delay_next_rpc = 0.0
        # Installed by a supervising Gateway: called with this worker
        # when an RPC dies under a read path; returns True when the
        # worker was respawned in place (safe to retry a read), False
        # when unsupervised or quarantined.
        self.recovery_hook: Optional[Callable[["ProcShardWorker"], bool]] = None
        # Serializes request/reply pairs on the one channel: the worker
        # thread is the steady-state caller but control-plane reads
        # (health probes under load, ledger snapshots) share it.
        self._rpc_lock = make_lock("procworker.rpc")
        self.worker_id = worker_id
        t0 = time.perf_counter()
        self._spawn(worker_id)
        super().__init__(worker_id, metrics)
        self.rpc({"op": "ping"})  # fail fast if the child can't serve
        self.child_starts_ms.append((time.perf_counter() - t0) * 1e3)

    def _spawn(self, worker_id: int) -> None:
        """Bind a fresh generation socket, spawn the child, accept."""
        name = f"rpc{self._generation}.sock" if self._generation else "rpc.sock"
        path = os.path.join(self._sock_dir, name)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(path)
        self._listener.listen(1)
        cmd = [
            self._python or sys.executable,
            "-m",
            "distilp_torch.gateway.procworker",
            "--socket",
            path,
        ]
        # The child imports this package from the same checkout, wherever
        # the parent was started.
        root = str(Path(__file__).resolve().parents[2])
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, env.get("PYTHONPATH")) if p
        )
        if self._compile_ledger:
            cmd.append("--compile-ledger")
        self._proc = subprocess.Popen(cmd, env=env)
        self._listener.settimeout(self._spawn_timeout_s)
        try:
            self._conn, _ = self._listener.accept()
        except socket.timeout:
            self._proc.kill()
            raise RuntimeError(
                f"process worker {worker_id} child did not connect within "
                f"{self._spawn_timeout_s}s"
            )
        self._conn.settimeout(None)

    # -- channel -----------------------------------------------------------

    def rpc(self, req: dict) -> Any:
        delay = self._delay_next_rpc
        if delay:
            self._delay_next_rpc = 0.0
            time.sleep(delay)
        try:
            with self._rpc_lock:
                send_frame(self._conn, req)
                reply = recv_frame(self._conn)
        except (EOFError, OSError) as e:
            # Send hit a broken pipe, or recv saw bytes-then-EOF: the
            # child died mid-call. Typed so callers (and the HTTP
            # ladder) can tell a crashed worker from a client hangup.
            raise WorkerCrashed(
                self.worker_id,
                self._reap_returncode(),
                req.get("op"),
                self.depth(),
                detail=str(e),
            ) from e
        if reply is None:
            raise WorkerCrashed(
                self.worker_id,
                self._reap_returncode(),
                req.get("op"),
                self.depth(),
                detail="clean EOF at frame boundary",
            )
        if "nvcc" in reply:
            self.child_nvcc_runs[self._generation] = reply["nvcc"]
        if reply.get("ok"):
            return reply.get("result")
        exc = reply.get("exc")
        if isinstance(exc, BaseException):
            raise exc
        raise RuntimeError(f"process worker {self.worker_id}: {exc}")

    def _reap_returncode(self) -> Optional[int]:
        """The child's exit status for a WorkerCrashed. The socket EOF
        races the SIGCHLD: the parent's blocked recv often notices the
        death before the corpse is reapable, and a bare ``poll()`` would
        report ``None`` — erasing the taxonomy (SIGKILL's -9 vs a torn
        frame's deliberate nonzero exit). A dead peer implies an exit is
        imminent, so a short wait is bounded in practice."""
        rc = self._proc.poll()
        if rc is not None:
            return rc
        try:
            return self._proc.wait(timeout=2.0)
        except Exception:  # dlint: disable=DLP017 the exit status is diagnostic garnish; a child that outlives the wait is reaped by stop()/respawn and the crash itself is already being raised
            return None

    # -- supervision surface ----------------------------------------------

    def child_alive(self) -> bool:
        return self._proc.poll() is None

    @property
    def child_pid(self) -> int:
        return self._proc.pid

    @property
    def generation(self) -> int:
        return self._generation

    def ensure_recovered(self) -> bool:
        """Route a crashed read through the gateway's supervisor (if one
        is installed). True → respawned in place, retry the read."""
        hook = self.recovery_hook
        if hook is None:
            return False
        return bool(hook(self))

    def respawn_child(self) -> int:
        """Tear the dead channel down, spawn a fresh child, re-ping.

        The caller (the gateway's supervisor) owns shard state: after
        this returns the child is EMPTY — every shard must be rebuilt
        from its spec + micro-snapshot and the WAL tail replayed before
        the worker serves again. Returns the new child pid.
        """
        for s in (self._conn, self._listener):
            try:
                s.close()
            except OSError:  # dlint: disable=DLP017 closing a channel the dead child already tore down; the respawn below is the observable outcome
                pass
        try:
            self._proc.kill()
            self._proc.wait(timeout=5.0)
        except Exception:  # dlint: disable=DLP017 reaping an already-dead child can raise; the fresh spawn below is the enforcement
            pass
        self._generation += 1
        t0 = time.perf_counter()
        self._spawn(self.worker_id)
        self.rpc({"op": "ping"})
        self.child_starts_ms.append((time.perf_counter() - t0) * 1e3)
        return self._proc.pid

    # -- process-level chaos primitives (sched/faults.py drives these) ----

    def kill_child(self) -> Optional[int]:
        """SIGKILL the child (chaos ``child_kill``). The next RPC — or
        the one currently blocked on the socket — raises WorkerCrashed."""
        try:
            self._proc.kill()
            self._proc.wait(timeout=5.0)
        except Exception:  # dlint: disable=DLP017 chaos primitive: the child may already be dead; the WorkerCrashed on the next RPC is the observable signal
            pass
        return self._proc.poll()

    def inject_torn_frame(self) -> None:
        """Half-close the channel mid-frame (chaos ``rpc_torn``): write a
        partial length header, then shut the socket down. The child's
        ``_recv_exact`` sees bytes-then-EOF → EOFError → nonzero exit (a
        torn peer must never parse as a frame); the parent's next RPC
        raises WorkerCrashed on the closed channel."""
        with self._rpc_lock:
            try:
                self._conn.sendall(_LEN.pack(1 << 20)[: _LEN.size // 2])
                self._conn.shutdown(socket.SHUT_RDWR)
            except OSError:  # dlint: disable=DLP017 chaos primitive: channel already dead is the same observable outcome (next RPC raises WorkerCrashed)
                pass
            self._conn.close()
        try:
            self._proc.wait(timeout=5.0)
        except Exception:  # dlint: disable=DLP017 a child that survives a torn channel gets SIGKILLed; either way the next RPC raises WorkerCrashed
            self._proc.kill()

    def inject_rpc_delay(self, delay_s: float) -> None:
        """One-shot latency injection (chaos ``rpc_delay``): the next RPC
        sleeps ``delay_s`` before dispatch, stretching the tick without
        killing anything — the degraded-but-alive corner of the plan."""
        self._delay_next_rpc = float(delay_s)

    # -- shard lifecycle ---------------------------------------------------

    def create_shard(self, key: str, build=None, state=None, spec=None):
        """Build the shard IN the child from its picklable ``spec``; the
        parent installs a proxy. Runs as a queued closure so registration
        keeps the thread backend's FIFO placement behind queued work."""
        if spec is None:
            raise RuntimeError(
                "process workers need a picklable build spec (a callable "
                "scheduler_factory cannot cross a process boundary — pass "
                "a 'module:callable' factory string instead)"
            )

        def _do():
            self.rpc({"op": "build", "key": key, "spec": spec, "state": state})
            self.shards[key] = SchedulerProxy(self, key)

        self.call(_do)

    # -- shutdown ----------------------------------------------------------

    def stop(self, join: bool = True, timeout: float = 5.0) -> None:
        """Base stop drains the queue and closes every proxy (child-side
        drops), then the child itself is stopped and reaped. ``join`` is
        forced: the child teardown RPC must not race queued drop RPCs."""
        with self._submit_lock:
            already = self._stopped
        super().stop(join=True, timeout=timeout)
        if already:
            return
        try:
            self.rpc({"op": "stop"})
        except Exception:  # dlint: disable=DLP017 teardown race: the child may have exited on socket EOF before the stop RPC lands; proc.wait/kill below is the enforcement
            pass
        try:
            self._proc.wait(timeout=timeout)
        except Exception:  # dlint: disable=DLP017 the recovery IS the recording: a child that ignores stop gets SIGKILLed, never orphaned
            self._proc.kill()
        for s in (self._conn, self._listener):
            try:
                s.close()
            except Exception:  # dlint: disable=DLP017 socket already torn down by the dead child; nothing to account
                pass
        import shutil

        shutil.rmtree(self._sock_dir, ignore_errors=True)

    def retire_crashed(self) -> None:
        """Teardown FROM this worker's own thread, child already dead:
        the quarantine path runs inside one of our queued closures, so
        ``stop()``'s forced join would deadlock on ourselves. Marks the
        queue stopped (the sentinel still drains queued closures first —
        supervised ones forward themselves to the shard's new owner),
        reaps the corpse, and releases the sockets. No stop RPC: there
        is no child to answer it."""
        # Drop the dead proxies BEFORE the stop sentinel's _close_all
        # drains: each close would RPC a corpse and raise into a box
        # nobody reads. The shards were already re-homed.
        self.shards.clear()
        super().stop(join=False)
        try:
            self._proc.kill()
            self._proc.wait(timeout=5)
        except Exception:  # dlint: disable=DLP017 the child is already a corpse (or reaped); this kill is belt-and-braces against a half-dead child, not a recordable failure
            pass
        for s in (self._conn, self._listener):
            try:
                s.close()
            except Exception:  # dlint: disable=DLP017 socket already torn down by the dead child; nothing to account
                pass
        import shutil

        shutil.rmtree(self._sock_dir, ignore_errors=True)

    # -- child observability -------------------------------------------------

    def ledger_counters(self) -> Optional[dict]:
        """The CHILD's compile-ledger counters (None when not enabled):
        each child process keeps its own ledger of the kernel libraries it
        loads and the graphs it captures."""
        return self.rpc({"op": "ledger_counters"})

    def child_report(self) -> dict:
        """What the parent saw of its children: each generation's start
        (spawn to first ping, ms) and its ``nvcc`` runs."""
        return {
            "worker": self.worker_id,
            "generations": self._generation + 1,
            "start_ms": [round(t, 3) for t in self.child_starts_ms],
            "nvcc_runs": dict(self.child_nvcc_runs),
        }


# -- child side -----------------------------------------------------------


def _child_build(shards: Dict[str, Any], req: dict) -> None:
    spec = req["spec"]
    if spec.get("factory"):
        factory = resolve_factory(spec["factory"])
        devices = spec["devices"]
        model = spec["model"]
        if devices and all(isinstance(d, dict) for d in devices):
            from ..common import DeviceProfile

            devices = [DeviceProfile.model_validate(d) for d in devices]
        if isinstance(model, dict):
            from ..common import ModelProfile

            model = ModelProfile.model_validate(model)
        sched = factory(devices, model)
    else:
        from ..common import DeviceProfile, ModelProfile
        from ..sched.scheduler import Scheduler

        devices = [
            DeviceProfile.model_validate(d) for d in spec["devices"]
        ]
        model = (
            ModelProfile.model_validate(spec["model"])
            if spec.get("model") is not None
            else None
        )
        sched = Scheduler(devices, model, **dict(spec.get("kwargs") or {}))
    if req.get("state") is not None:
        sched.load_state(req["state"])
    shards[req["key"]] = sched


def _child_dispatch(shards: Dict[str, Any], req: dict) -> Any:
    op = req["op"]
    if op == "ping":
        return os.getpid()
    if op == "build":
        _child_build(shards, req)
        return None
    if op == "call":
        sched = shards[req["key"]]
        out = getattr(sched, req["method"])(
            *req.get("args", ()), **req.get("kwargs", {})
        )
        if req["method"] in _VIEW_METHODS:
            return _view_to_wire(out)
        return out
    if op == "getattr":
        return getattr(shards[req["key"]], req["name"])
    if op == "setattr":
        setattr(shards[req["key"]], req["name"], req["value"])
        return None
    if op == "metrics":
        m = shards[req["key"]].metrics
        return {"counters": dict(m.counters), "snapshot": m.snapshot()}
    if op == "fleet_view":
        sched = shards[req["key"]]
        fleet = getattr(sched, "fleet", None)
        if fleet is None:
            return None
        model = getattr(fleet, "model", None)
        devices = getattr(fleet, "devices", None) or {}
        # The published seq lives on the scheduler's placement record,
        # not the fleet — mirror ShardFacade's thread-path `_capture`.
        pub = getattr(sched, "_published", None)
        return {
            "seq": getattr(fleet, "seq", 0),
            "published_seq": None if pub is None else getattr(pub, "seq", None),
            "model": model.model_dump() if hasattr(model, "model_dump") else None,
            "devices": {
                did: d.model_dump() if hasattr(d, "model_dump") else d
                for did, d in dict(devices).items()
            },
        }
    if op == "drop":
        sched = shards.pop(req["key"], None)
        if sched is not None:
            sched.close()
        return None
    if op == "ledger_counters":
        from ..obs import compile_ledger as _cl

        led = _cl.current()
        return led.counters() if led is not None else None
    raise ValueError(f"unknown procworker op {op!r}")


def child_main(argv: Optional[list] = None) -> int:
    """The worker subprocess: connect, then serve one request at a time.

    Single-threaded by design — the parent's worker thread already
    serializes shard work, so a concurrent child would only add races.
    Clean EOF (parent died or closed) exits 0 after closing shards: an
    orphaned child must not outlive its gateway.
    """
    import argparse

    from ..kernels.build import BUILD_STATS

    ap = argparse.ArgumentParser(prog="distilp-procworker")
    ap.add_argument("--socket", required=True)
    ap.add_argument("--compile-ledger", action="store_true")
    args = ap.parse_args(argv)

    if args.compile_ledger:
        from ..obs import compile_ledger as _cl

        _cl.enable()

    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(args.socket)
    shards: Dict[str, Any] = {}
    try:
        while True:
            req = recv_frame(sock)
            if req is None:
                break
            if req.get("op") == "stop":
                send_frame(sock, {"ok": True, "result": None})
                break
            try:
                result = _child_dispatch(shards, req)
                reply = {"ok": True, "result": result}
            except BaseException as e:  # dlint: disable=DLP017 not swallowed: the exception crosses the wire in the reply and re-raises parent-side, where the worker's metrics sink lives
                try:
                    pickle.dumps(e)
                    reply = {"ok": False, "exc": e}
                except Exception:  # dlint: disable=DLP017 the failure is not swallowed — it crosses the wire as a repr string and re-raises parent-side
                    reply = {"ok": False, "exc": f"{type(e).__name__}: {e}"}
            reply["nvcc"] = int(BUILD_STATS.get("nvcc_runs", 0))
            send_frame(sock, reply)
    finally:
        for sched in shards.values():
            try:
                sched.close()
            except Exception:  # dlint: disable=DLP017 child exit path: the process dies next line, there is no sink left to record into
                pass
        try:
            sock.close()
        except Exception:  # dlint: disable=DLP017 child exit path: the process is exiting, the parent's EOF read is the signal
            pass
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    sys.exit(child_main())
