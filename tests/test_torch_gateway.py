"""The port's gateway tier (``distilp_torch/gateway``) against the JAX
package's (``distilp_tpu/gateway``), on the CPU.

The cut: fleets f003-f006 of ``tests/traces/gateway_smoke_10f.jsonl`` (two
of 3 devices, two of 4; Llama-3-70B online, k in {8, 10}, gap 1e-3, kv
4bit) and their 12 events, through thread-backed gateways of 2 workers.

- Per fleet both gateways serve the same sequence of tick modes, the same
  final (k, w, n), and objectives within the gap at every tick.
- The port's snapshot halted mid-trace resumes in a gateway of another
  worker count: final placements identical to the uninterrupted run, every
  restored shard's first tick warm, zero cold re-solves.
- A JAX gateway's snapshot (its JSON file) passes through
  ``interop.gateway_snapshot_from_jax`` into the port's gateway: each
  shard's next tick is warm, and its placement equals the JAX gateway's
  after its own resume.
- The HTTP API answers POST /events, GET /placement, /healthz, /metrics
  (JSON and Prometheus text) and 404s; at ``max_queue_depth=1`` a post gets
  429 with a parseable Retry-After, ordered by the worker's observed queue
  depth (no sleeps).
- ``serve --workers 2 --device cpu`` runs the JAX package's
  ``make smoke-gateway`` to its contract (uninterrupted, snapshot + halt,
  resume: identical placements, warm resumes, no cold re-solve).
- Without a GPU the gateway, the combiner and the load generator raise
  unless the caller asks for the CPU; the ledger knobs are accepted.

~25 s in one process (the JAX side's compiles come from the persistent
cache).
"""

import asyncio
import json
import threading
import urllib.request
from urllib.error import HTTPError
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from distilp_tpu import gateway as jgateway  # noqa: E402
from distilp_tpu.common import load_model_profile as jload_model  # noqa: E402

from distilp_torch import gateway  # noqa: E402
from distilp_torch.cli import solver_cli  # noqa: E402
from distilp_torch.common import load_model_profile  # noqa: E402
from distilp_torch.sched import LoadTick  # noqa: E402

GAP = 1e-3
KS = [8, 10]
ONLINE = "tests/profiles/llama_3_70b/online"
TRACE = "tests/traces/gateway_smoke_10f.jsonl"
FLEETS = ("f003", "f004", "f005", "f006")


@pytest.fixture(scope="module")
def model():
    return load_model_profile(f"{ONLINE}/model_profile.json")


@pytest.fixture(scope="module")
def jmodel():
    return jload_model(f"{ONLINE}/model_profile.json")


def _cut(pkg):
    specs, items = pkg.read_gateway_trace(TRACE)
    return ({f: specs[f] for f in FLEETS}, [(f, ev) for f, ev in items if f in FLEETS])


def port_gateway(model, n_workers=2, register=True, **kw):
    gw = gateway.Gateway(n_workers=n_workers, device="cpu", scheduler_kwargs=dict(
        mip_gap=GAP, kv_bits="4bit", k_candidates=KS), **kw)
    if register:
        specs, _ = _cut(gateway)
        for f, spec in specs.items():
            gw.register_fleet(f, gateway.make_fleet_from_spec(f, spec), model)
    return gw


def jax_gateway(jmodel, n_workers=2, register=True):
    gw = jgateway.Gateway(n_workers=n_workers, scheduler_kwargs=dict(
        mip_gap=GAP, kv_bits="4bit", k_candidates=KS, backend="jax"))
    if register:
        specs, _ = _cut(jgateway)
        for f, spec in specs.items():
            gw.register_fleet(f, jgateway.make_fleet_from_spec(f, spec), jmodel)
    return gw


def _replay(gw, items):
    """Per fleet: the views served, in order."""
    out = {}
    for f, ev in items:
        out.setdefault(f, []).append(gw.handle_event(f, ev))
    return out


def _placement(view):
    r = view.result
    return r.k, tuple(r.w), tuple(r.n)


def _within_gap(a, b):
    return abs(a - b) <= GAP * abs(b)


def test_gateway_ticks_match_the_reference(model, jmodel):
    _, items = _cut(gateway)
    _, jitems = _cut(jgateway)
    ours, theirs = port_gateway(model), jax_gateway(jmodel)
    try:
        assert ours.router.assignments(list(ours._shards)) == theirs.router.assignments(
            list(theirs._shards))
        views, jviews = _replay(ours, items), _replay(theirs, jitems)
        totals = ours.metrics_snapshot()["shard_totals"]
        jtotals = theirs.metrics_snapshot()["shard_totals"]
    finally:
        ours.close()
        theirs.close()
    assert set(views) == set(jviews) == set(FLEETS)
    for f in FLEETS:
        assert [v.mode for v in views[f]] == [v.mode for v in jviews[f]], f
        for v, jv in zip(views[f], jviews[f]):
            assert v.result.certified and jv.result.certified
            assert _within_gap(v.result.obj_value, jv.result.obj_value), f
        assert _placement(views[f][-1]) == _placement(jviews[f][-1]), f
    for name in ("events_total", "tick_cold", "tick_warm", "tick_certified", "tick_failed"):
        assert totals.get(name, 0) == jtotals.get(name, 0), name


def test_snapshot_halt_and_resume_is_identical_and_warm(model, tmp_path):
    _, items = _cut(gateway)
    full = port_gateway(model)
    try:
        finals = {f: vs[-1] for f, vs in _replay(full, items).items()}
    finally:
        full.close()
    first = port_gateway(model)
    try:
        _replay(first, items[:6])
        gateway.save_snapshot(first.snapshot(), tmp_path)
    finally:
        first.close()
    snap = gateway.load_snapshot(tmp_path)
    resumed = port_gateway(model, n_workers=3, register=False)
    try:
        resumed.load_snapshot(snap)
        rest = resumed.uncovered(items)
        assert len(rest) == len(items) - 6
        after = _replay(resumed, rest)
        totals = resumed.metrics_snapshot()["shard_totals"]
    finally:
        resumed.close()
    for f in FLEETS:
        assert _placement(after[f][-1]) == _placement(finals[f])
        assert after[f][-1].result.obj_value == finals[f].result.obj_value
    assert totals["warm_resumes"] == len(FLEETS)
    assert totals.get("cold_resumes", 0) == 0 and totals.get("tick_cold", 0) == 0


def test_jax_snapshot_resumes_warm_in_the_port(model, jmodel, tmp_path):
    from distilp_torch.interop import gateway_snapshot_from_jax

    _, items = _cut(gateway)
    _, jitems = _cut(jgateway)
    theirs = jax_gateway(jmodel)
    try:
        _replay(theirs, jitems[:6])
        jgateway.save_snapshot(theirs.snapshot(), tmp_path)
    finally:
        theirs.close()
    text = jgateway.snapshot_path(tmp_path).read_text()
    snap = gateway_snapshot_from_jax(text)
    assert isinstance(snap, gateway.GatewaySnapshot)
    ours = port_gateway(model, register=False)
    theirs = jax_gateway(jmodel, register=False)
    try:
        ours.load_snapshot(snap)
        theirs.load_snapshot(jgateway.load_snapshot(tmp_path))
        rest, jrest = ours.uncovered(items), theirs.uncovered(jitems)
        assert [f for f, _ in rest] == [f for f, _ in jrest] and rest
        views, jviews = _replay(ours, rest), _replay(theirs, jrest)
        totals = ours.metrics_snapshot()["shard_totals"]
    finally:
        ours.close()
        theirs.close()
    for f in views:
        assert views[f][0].mode == jviews[f][0].mode == "warm", f
        assert _placement(views[f][-1]) == _placement(jviews[f][-1]), f
        assert _within_gap(views[f][-1].result.obj_value, jviews[f][-1].result.obj_value)
    assert totals["warm_resumes"] == len(views)
    assert totals.get("cold_resumes", 0) == 0 and totals.get("tick_cold", 0) == 0
    with pytest.raises(ValueError, match="version"):
        gateway_snapshot_from_jax({**json.loads(text), "version": 9})


def _post(port, payload, path="/events"):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(), method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, dict(r.headers), json.loads(r.read())
    except HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _get(port, path, accept=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 headers={"Accept": accept} if accept else {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            body = r.read()
            return r.status, (body.decode() if accept else json.loads(body))
    except HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_api_roundtrip(model):
    gw = port_gateway(model)

    async def main():
        srv = gateway.GatewayHTTPServer(gw)
        await srv.start()
        loop = asyncio.get_running_loop()
        call = lambda *a: loop.run_in_executor(None, *a)  # noqa: E731
        try:
            st, _, out = await call(_post, srv.port,
                                    {"fleet": "f004", "event": {"kind": "load"}})
            assert st == 200 and out["view"]["certified"] and out["view"]["k"] in KS
            st, out = await call(_get, srv.port, "/placement/f004")
            assert st == 200 and out["view"]["events_behind"] == 0
            st, out = await call(_get, srv.port, "/healthz")
            assert st == 200 and out["status"] == "healthy" and len(out["shards"]) == 4
            st, out = await call(_get, srv.port, "/metrics")
            assert st == 200 and out["counters"]["gateway_events"] == 1
            assert out["shard_totals"]["tick_certified"] == 1
            st, text = await call(_get, srv.port, "/metrics", "text/plain")
            assert st == 200 and 'fleet="f004"' in text and "worker_queue_depth" in text
            assert (await call(_get, srv.port, "/placement/ghost"))[0] == 404
            assert (await call(_get, srv.port, "/signals"))[0] == 404
            assert (await call(_get, srv.port, "/nope"))[0] == 404
            return (await call(_post, srv.port, {"fleet": "f004"}))[0]
        finally:
            await srv.close()

    try:
        assert asyncio.run(main()) == 400  # an event-less POST is a client error
    finally:
        gw.close()


class GatedScheduler:
    """A solver-free shard whose ticks block on ``gate`` once ``entered``
    says the worker is inside one."""

    def __init__(self, gate, entered):
        from distilp_torch.sched.metrics import SchedulerMetrics

        self.gate, self.entered = gate, entered
        self.metrics = SchedulerMetrics()
        self.health = "healthy"
        self.seq = 0

    def handle(self, event, pressure=False):
        self.entered.set()
        assert self.gate.wait(timeout=60)
        self.seq += 1
        self.metrics.inc("events_total")
        r = SimpleNamespace(k=2, w=[1, 1], n=[4, 4], y=None, obj_value=1.0, certified=True,
                            gap=0.0)
        return SimpleNamespace(result=r, seq=self.seq, fleet_seq=self.seq, events_behind=0,
                               age_s=0.0, mode="warm", twin_p95_s=None, risk_selected=False)

    def health_snapshot(self):
        return {"state": "healthy"}

    def close(self):
        pass


def test_http_429_carries_parseable_retry_after(model):
    gate, entered = threading.Event(), threading.Event()
    gw = gateway.Gateway(n_workers=1, device="cpu", max_queue_depth=1,
                         scheduler_factory=lambda d, m: GatedScheduler(gate, entered))
    gw.register_fleet("f0", gateway.make_fleet_from_spec("f0", {"m": 2, "seed": 0}), model)
    worker = gw.workers[0]

    def wait_for(cond):
        for _ in range(6000):
            if cond():
                return
            threading.Event().wait(0.005)
        raise AssertionError("the gateway never reached the expected queue state")

    async def main():
        srv = gateway.GatewayHTTPServer(gw)
        await srv.start()
        loop = asyncio.get_running_loop()
        body = {"fleet": "f0", "event": {"kind": "load"}}
        try:
            # The worker takes the first event and blocks inside it ...
            t1 = loop.run_in_executor(None, _post, srv.port, body)
            await loop.run_in_executor(None, wait_for, entered.is_set)
            assert worker.depth() == 0
            # ... the second fills the 1-deep queue ...
            t2 = loop.run_in_executor(None, _post, srv.port, body)
            await loop.run_in_executor(None, wait_for, lambda: worker.depth() == 1)
            # ... and the third finds it full.
            third = await loop.run_in_executor(None, _post, srv.port, body)
            gate.set()
            return await t1, await t2, third
        finally:
            gate.set()
            await srv.close()

    try:
        r1, r2, (st, headers, body) = asyncio.run(main())
        assert r1[0] == 200 and r2[0] == 200
        assert st == 429
        assert int(headers["Retry-After"]) >= 1
        assert body["retry_after_s"] > 0 and body["fleet"] == "f0" and body["depth"] == 1
        counters = gw.metrics_snapshot()["counters"]
        assert counters["http_too_many_requests"] == 1 and counters["events_shed"] == 1
        assert gw.shed_counts() == {"f0": 1}
    finally:
        gate.set()
        gw.close()


def test_serve_gateway_snapshot_halt_and_resume(tmp_path, capsys):
    base = ["serve", "--trace", TRACE, "--profile", ONLINE, "--workers", "2",
            "--k-candidates", "8,10", "--quiet", "--device", "cpu"]
    runs = [
        base + ["--fail-uncertified", "--metrics-out", str(tmp_path / "full.json")],
        base + ["--snapshot-dir", str(tmp_path / "snap"), "--snapshot-at", "15",
                "--halt-after-snapshot"],
        base + ["--fail-uncertified", "--snapshot-dir", str(tmp_path / "snap"), "--resume",
                "--metrics-out", str(tmp_path / "resumed.json")],
    ]
    for argv in runs:
        assert solver_cli.main(argv) == 0, capsys.readouterr().err[-3000:]
    full = json.loads((tmp_path / "full.json").read_text())
    res = json.loads((tmp_path / "resumed.json").read_text())
    assert res["final_placements"] == full["final_placements"]
    g = res["gateway"]
    assert g["resumed"] and g["fleets"] == 10 and g["warm_resumes"] > 0
    assert g["cold_resumes"] == 0 and g["tick_cold"] == 0
    assert full["replay"]["events"] == 30 and res["replay"]["events"] == 15


def test_gateway_needs_a_gpu_unless_asked_for_the_cpu(model, monkeypatch):
    from distilp_torch.combine import SolveCombiner
    from distilp_torch.gateway.procworker import ProcShardWorker

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        gateway.Gateway(n_workers=1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        SolveCombiner()
    with pytest.raises(RuntimeError, match="CUDA device"):
        gateway.run_loadgen(model, n_fleets=1, n_workers=1)
    # The ledger knobs of A14b are part of the port now: each is accepted.
    gw = gateway.Gateway(n_workers=1, device="cpu", mem_degrade_headroom_bytes=1e9)
    try:
        # No memory ledger: no verdict, so no pressure.
        assert gw.mem_degrade_headroom_bytes == 1e9 and not gw._mem_pressure()
    finally:
        gw.close()
    report = gateway.run_loadgen(model, n_fleets=1, n_workers=1, events_per_fleet=1,
                                 k_candidates=KS, device="cpu", compile_ledger=True)
    # On the CPU nothing is built or captured.
    assert report["compile"]["cold_compiles"] == 0
    assert report["compile"]["warm_phase_compiles"] == 0
    # A child's counters come over the RPC.
    assert ProcShardWorker.ledger_counters(SimpleNamespace(rpc=lambda req: req)) == {
        "op": "ledger_counters"}
    gw = gateway.Gateway(n_workers=1, device="cpu")
    try:
        assert gw.device.type == "cpu" and gw.scheduler_kwargs["device"] == "cpu"
        gw.register_fleet("f0", gateway.make_fleet_from_spec("f0", {"m": 3, "seed": 100}),
                          model)
        view = gw.handle_event("f0", LoadTick(t_comm_jitter={}))
        assert view.result.certified
        gw.configure_admission(mem_degrade_headroom_bytes=1e9)
        assert gw.mem_degrade_headroom_bytes == 1e9
    finally:
        gw.close()


def test_loadgen_reports_on_the_cpu(model):
    report = gateway.run_loadgen(model, n_fleets=2, n_workers=2, events_per_fleet=2,
                                 k_candidates=KS, device="cpu")
    assert report["device"] == "cpu" and report["events"] == 4
    assert report["tick_failed"] == 0 and report["uncertified"] == 0
    assert report["p50_ms"] > 0 and sum(report["worker_events"]) >= 4
