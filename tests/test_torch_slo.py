"""The SLO engine in the port (``distilp_torch.obs.slo``,
``obs.timeline.synthesize_overload_timeline``) against the JAX package's,
on the CPU. Every comparison is exact.

- ``synthesize_overload_timeline``: the port's dump equals the reference's
  and the committed ``tests/traces/slo_timeline_overload.jsonl``, byte for
  byte (the recipe and a short variant).
- ``SLOEngine.replay`` over the committed timeline and spec: the same
  transitions as the reference's replay, which bucket to the committed
  ``slo_expected_alerts.json``; the counters and flight records reconcile.
- ``build_signals`` on one hand-built timeline with an engine, a capacity,
  combiner and recovery blocks: ``model_dump`` equal to the reference's.
- ``evaluate_history`` on ``BENCH_HISTORY.jsonl``: the same table and
  violations.
- The port's gateway serves ``GET /slo`` and ``GET /signals`` (schema'd by
  ``SignalsPayload``) from its attached engine and timeline.

~3 s in one process.
"""

import asyncio
import json
import time
import urllib.request
from urllib.error import HTTPError

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_tpu import obs as jobs  # noqa: E402
from distilp_tpu.obs import slo as jslo  # noqa: E402
from distilp_tpu.sched.metrics import SchedulerMetrics as JMetrics  # noqa: E402

from distilp_torch import obs  # noqa: E402
from distilp_torch.gateway import Gateway, GatewayHTTPServer  # noqa: E402
from distilp_torch.obs import slo  # noqa: E402
from distilp_torch.sched.metrics import SchedulerMetrics  # noqa: E402

TRACES = "tests/traces"


@pytest.mark.parametrize("kw", [{}, dict(duration_s=12.0, period_s=0.5, burst_start_s=3.0,
                                         burst_end_s=6.0, offered_eps=120.0,
                                         shed_frac=0.5)], ids=["recipe", "short"])
def test_overload_timeline_dump_matches_the_reference_and_fixture(kw):
    text = obs.synthesize_overload_timeline(**kw).to_jsonl()
    assert text == jobs.synthesize_overload_timeline(**kw).to_jsonl()
    if not kw:
        assert text == open(f"{TRACES}/slo_timeline_overload.jsonl").read()
    # A load of the dump re-dumps byte for byte in both packages.
    assert obs.Timeline.from_jsonl(text).to_jsonl() == text
    assert jobs.Timeline.from_jsonl(text).to_jsonl() == text


def test_slo_replay_matches_the_reference_and_the_expected_alerts():
    cfg = slo.SLOConfig.from_json(f"{TRACES}/slo_overload_spec.json")
    jcfg = jslo.SLOConfig.from_json(f"{TRACES}/slo_overload_spec.json")
    assert cfg.model_dump() == jcfg.model_dump()
    tl = obs.Timeline.load(f"{TRACES}/slo_timeline_overload.jsonl")
    jtl = jobs.Timeline.load(f"{TRACES}/slo_timeline_overload.jsonl")
    metrics, flight = SchedulerMetrics(), obs.FlightRecorder(capacity=4096)
    engine = slo.SLOEngine(cfg, tl, metrics=metrics, flight=flight)
    jengine = jslo.SLOEngine(jcfg, jtl, metrics=JMetrics())
    events = engine.replay(step_s=0.1)
    assert events == jengine.replay(step_s=0.1) and events
    assert engine.status() == jengine.status()
    expect = json.loads(open(f"{TRACES}/slo_expected_alerts.json").read())
    t0 = tl.bounds()[0]
    got = [{"slo": e["slo"], "severity": e["severity"], "state": e["state"],
            "bucket": int((e["t"] - t0) / expect["bucket_s"])} for e in events]
    assert got == expect["events"]
    counters = metrics.snapshot()["counters"]
    assert counters["slo_alert_opened"] == sum(e["state"] == "open" for e in events)
    assert counters["slo_alert_closed"] == sum(e["state"] == "close" for e in events)
    assert len([r for r in flight.snapshot("slo") if r.get("kind") == "slo_alert"]) == len(
        events)


def _signals_timeline(mod):
    tl = mod.Timeline()
    for i in range(61):
        tl.record_many(i * 1.0, {
            "queue_depth.w0": 0.1 * i, "queue_depth.w1": 2.0 if i % 7 else 0.0,
            "c.gateway_events": 10.0 * i, "c.events_shed": 0.5 * i * (i > 30),
        })
    return tl


def test_build_signals_matches_the_reference():
    spec = {"slos": [{"name": "avail", "kind": "ratio", "objective": 0.99,
                      "bad_series": "c.events_shed", "total_series": "c.gateway_events",
                      "alerts": [{"severity": "page", "windows": [
                          {"window_s": 10.0, "burn_rate": 2.0},
                          {"window_s": 2.0, "burn_rate": 2.0}]}]}]}
    cfg, jcfg = slo.SLOConfig.model_validate(spec), jslo.SLOConfig.model_validate(spec)
    tl, jtl = _signals_timeline(obs), _signals_timeline(jobs)
    engine, jengine = slo.SLOEngine(cfg, tl), jslo.SLOEngine(jcfg, jtl)
    for t in (40.0, 50.0, 60.0):
        assert engine.evaluate(t) == jengine.evaluate(t)
    combine = {"batches": 3, "instances": 12, "flush_full": 1, "flush_deadline": 2,
               "errors": 0, "pending": 1, "buckets": 2, "occupancy_mean": 0.5,
               "padding_waste_mean": 0.25}
    recovery = {"worker_crashes": 1, "workers_quarantined": 0, "events_lost": 0}
    for now in (None, 45.5, 60.0):
        kw = dict(capacity_eps=25.0, now=now, combine=combine, recovery=recovery)
        sig = slo.build_signals(tl, engine=engine, **kw).model_dump()
        assert sig == jslo.build_signals(jtl, engine=jengine, **kw).model_dump()
        assert slo.SignalsPayload.model_validate(sig).version == 1
    assert slo.build_signals(tl).model_dump() == jslo.build_signals(jtl).model_dump()


def test_evaluate_history_matches_the_reference_on_the_bench_history():
    rows = [json.loads(ln) for ln in open("BENCH_HISTORY.jsonl") if ln.strip()]
    assert rows
    assert slo.evaluate_history(rows) == jslo.evaluate_history(rows)
    # And on a history whose newest round regressed.
    rows2 = rows + [dict(rows[-1], spec_hit_rate=0.0, value=1e9)]
    table, violations = slo.evaluate_history(rows2)
    assert (table, violations) == jslo.evaluate_history(rows2) and violations


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except HTTPError as e:
        return e.code, json.loads(e.read())


def test_gateway_serves_slo_and_signals():
    gw = Gateway(n_workers=2, device="cpu",
                 scheduler_factory="tests.torch_procstub:make_scheduler")
    tl = obs.Timeline()
    cfg = slo.SLOConfig.model_validate({"slos": [{
        "name": "avail", "kind": "ratio", "objective": 0.99, "bad_series": "c.events_shed",
        "total_series": "c.gateway_events",
        "alerts": [{"severity": "page", "windows": [{"window_s": 10.0,
                                                     "burn_rate": 10.0}]}]}]})
    engine = slo.SLOEngine(cfg, tl, metrics=gw.metrics)
    sampler = gw.attach_sampler(obs.TimelineSampler(
        tl, gw.timeline_sample, period_s=0.01, metrics=gw.metrics,
        on_sample=lambda _tl, now: engine.evaluate(now)))
    gw.attach_slo(engine, tl, capacity_eps=100.0)
    sampler.start()
    try:
        gw.register_fleet("f0", [], None)
        deadline = time.monotonic() + 5.0
        while sampler.samples < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        sampler.stop()  # a still timeline: the two reads below see the same
        assert sampler.samples >= 3
        assert gw.signals() == slo.build_signals(tl, engine=engine,
                                                 capacity_eps=100.0).model_dump()

        async def main():
            srv = GatewayHTTPServer(gw)
            await srv.start()
            loop = asyncio.get_running_loop()
            try:
                st, status = await loop.run_in_executor(None, _get, srv.port, "/slo")
                assert st == 200 and status["slos"][0]["name"] == "avail"
                assert status["alerts_open"] == 0
                st, sig = await loop.run_in_executor(None, _get, srv.port, "/signals")
                assert st == 200
                payload = slo.SignalsPayload.model_validate(sig)
                assert payload.max_sustainable_eps == 100.0
                assert [w.worker for w in payload.workers] == [0, 1]
                assert payload.mem_headroom_bytes is None  # no memory ledger
            finally:
                await srv.close()

        asyncio.run(main())
    finally:
        gw.close()
