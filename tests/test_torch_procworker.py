"""The port's process-backed workers and their supervision
(``distilp_torch/gateway/{procworker,recovery}.py``), on the CPU.

- The RPC framing (round trip, clean EOF, a torn frame) and the factory
  resolution; the backend gating (a callable factory, combine and an
  unsupervisable thread backend are refused).
- On the solver-free stub (``tests/torch_procstub.py``, the port's JAX-free
  copy of ``tests/procstub.py``): thread and process backends serve
  identically; a torn frame and a SIGKILL surface as ``WorkerCrashed`` with
  their exit codes; a supervised gateway recovers a SIGKILL exactly once
  from its micro-snapshot and WAL tail, warm. Each child reports its start
  and that it ran no ``nvcc``.
- One two-fleet process gateway whose children host the port's real
  ``Scheduler`` on the CPU (``device='cpu'`` rides their build spec): a
  ``child_kill`` fault in the middle of the trace is recovered by the
  supervisor with a warm resume, no event lost, and the final placements
  equal the thread backend's.

~20 s in one process (each child imports torch).
"""

import socket
import threading

import pytest

torch = pytest.importorskip("torch")

from distilp_torch.common import load_model_profile  # noqa: E402
from distilp_torch.gateway import Gateway, read_gateway_trace  # noqa: E402
from distilp_torch.gateway.procworker import (  # noqa: E402
    WorkerCrashed,
    recv_frame,
    resolve_factory,
    send_frame,
)
from distilp_torch.gateway.traces import make_fleet_from_spec  # noqa: E402

FACTORY = "tests.torch_procstub:make_scheduler"
ONLINE = "tests/profiles/llama_3_70b/online/model_profile.json"


def _gateway(n_fleets, n_workers=1, **kw):
    gw = Gateway(n_workers=n_workers, scheduler_factory=FACTORY, worker_backend="process",
                 device="cpu", **kw)
    for i in range(n_fleets):
        fid = f"p{i:02d}"
        gw.register_fleet(fid, make_fleet_from_spec(fid, {"m": 3, "seed": 700 + i}), "stub")
    return gw


def test_frame_roundtrip_over_socketpair():
    a, b = socket.socketpair()
    try:
        payloads = [{"op": "ping"}, {"nested": {"list": [1, 2.5, "three"], "none": None}},
                    {"big": "x" * 300_000}]
        got = []

        def reader():
            while (obj := recv_frame(b)) is not None:
                got.append(obj)

        t = threading.Thread(target=reader)
        t.start()
        for p in payloads:
            send_frame(a, p)
        a.close()
        t.join(timeout=10)
        assert not t.is_alive() and got == payloads
    finally:
        b.close()


def test_recv_frame_eof_and_torn_frame():
    a, b = socket.socketpair()
    a.close()
    try:
        assert recv_frame(b) is None
    finally:
        b.close()
    a, b = socket.socketpair()
    try:
        a.sendall((1 << 20).to_bytes(8, "big") + b"short")
        a.close()
        with pytest.raises(EOFError):
            recv_frame(b)
    finally:
        b.close()


def test_factory_resolution_and_backend_gating():
    import tests.torch_procstub as stub

    assert resolve_factory(FACTORY) is stub.make_scheduler
    with pytest.raises(ValueError):
        resolve_factory("no_colon_here")
    with pytest.raises(AttributeError):
        resolve_factory("tests.torch_procstub:no_such_callable")
    with pytest.raises(ValueError, match="factory"):
        Gateway(n_workers=1, scheduler_factory=lambda d, m: None, worker_backend="process",
                device="cpu")
    with pytest.raises(ValueError, match="combine"):
        Gateway(n_workers=1, scheduler_factory=FACTORY, worker_backend="process",
                device="cpu", combine=True)
    with pytest.raises(ValueError, match="supervise"):
        Gateway(n_workers=1, device="cpu", supervise=True)
    with pytest.raises(ValueError, match="worker_backend"):
        Gateway(n_workers=1, worker_backend="fiber", device="cpu")


def test_thread_and_process_backends_serve_identically():
    def run(backend):
        gw = Gateway(n_workers=2, scheduler_factory=FACTORY, worker_backend=backend,
                     device="cpu")
        try:
            for i in range(3):
                fid = f"t{i:02d}"
                gw.register_fleet(fid, make_fleet_from_spec(fid, {"m": 3, "seed": 800 + i}),
                                  "stub")
            views = [gw.handle_event(f"t{i:02d}", f"ev{j}") for j in range(4) for i in range(3)]
            reports = [w.child_report() for w in gw.live_workers()] if backend == "process" \
                else None
            return views, gw.metrics_snapshot()["shard_totals"], reports
        finally:
            gw.close()

    views_t, totals_t, _ = run("thread")
    views_p, totals_p, reports = run("process")
    assert views_t == views_p and totals_t == totals_p
    for rep in reports:
        assert rep["generations"] == 1 and len(rep["start_ms"]) == 1 and rep["start_ms"][0] > 0
        assert rep["nvcc_runs"] == {0: 0}


def test_torn_frame_and_sigkill_are_worker_crashed():
    gw = _gateway(n_fleets=1)
    try:
        fid = "p00"
        gw.handle_event(fid, "ev0")
        gw.workers[0].inject_torn_frame()
        with pytest.raises(WorkerCrashed) as ei:
            gw.handle_event(fid, "ev1")
        assert not isinstance(ei.value, (EOFError, RuntimeError))
        assert ei.value.returncode not in (None, 0, -9)
    finally:
        gw.close()
    gw = _gateway(n_fleets=1)
    try:
        gw.handle_event("p00", "ev0")
        gw.workers[0].kill_child()
        with pytest.raises(WorkerCrashed) as ei:
            gw.handle_event("p00", "ev1")
        assert ei.value.returncode == -9 and ei.value.op is not None
    finally:
        gw.close()


def test_supervised_sigkill_recovers_exactly_once_and_warm(tmp_path):
    gw = _gateway(n_fleets=2, supervise=True, recovery_dir=str(tmp_path), snapshot_every=2,
                  backoff_base_s=0.01, backoff_max_s=0.05)
    try:
        for j in range(3):
            for fid in ("p00", "p01"):
                assert gw.handle_event(fid, f"ev{j}")["seq"] == j + 1
        gw.workers[0].kill_child()
        for fid in ("p00", "p01"):
            assert gw.handle_event(fid, "post-kill")["seq"] == 4
        rec = gw.recovery_status()
        assert rec["worker_crashes"] == rec["child_respawns"] == 1
        assert rec["shards_recovered"] == 2 and rec["events_lost"] == 0
        assert rec["cold_resumes"] == 0 and rec["warm_resumes"] == 2
        assert [r["action"] for r in rec["recoveries"]] == ["respawn"]
        assert rec["recoveries"][0]["mttr_ms"] > 0 and rec["mttr_p99_ms"] > 0
        rep = gw.workers[0].child_report()
        assert rep["generations"] == 2 and len(rep["start_ms"]) == 2
        assert set(rep["nvcc_runs"].values()) == {0}
    finally:
        gw.close()


def test_real_schedulers_in_cpu_children_recover_warm_from_a_child_kill(tmp_path):
    model = load_model_profile(ONLINE)
    specs, items = read_gateway_trace("tests/traces/gateway_smoke_10f.jsonl")
    fleets = ("f003", "f005")
    items = [(f, ev) for f, ev in items if f in fleets]
    kw = dict(n_workers=2, device="cpu",
              scheduler_kwargs=dict(mip_gap=1e-3, kv_bits="4bit", k_candidates=[8, 10]))

    def run(**extra):
        gw = Gateway(**kw, **extra)
        try:
            for f in fleets:
                gw.register_fleet(f, make_fleet_from_spec(f, specs[f]), model)
            finals = {}
            for i, (f, ev) in enumerate(items):
                if i == 3 and extra:
                    gw.chaos_process_hook("f003")("child_kill", None)
                finals[f] = gw.handle_event(f, ev)
            rec = gw.recovery_status() if extra else None
            return finals, rec
        finally:
            gw.close()

    plain, _ = run()
    finals, rec = run(worker_backend="process", supervise=True, recovery_dir=str(tmp_path),
                      snapshot_every=2)
    assert rec["worker_crashes"] == rec["child_respawns"] == 1 and rec["events_lost"] == 0
    assert rec["warm_resumes"] >= 1 and rec["cold_resumes"] == 0
    for f in fleets:
        a, b = finals[f].result, plain[f].result
        assert a.certified and (a.k, a.w, a.n) == (b.k, b.w, b.n), f
        assert a.obj_value == b.obj_value
