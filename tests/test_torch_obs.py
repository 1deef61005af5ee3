"""The port's observability layer (``distilp_torch/obs``: trace, export,
flight, timeline; ``utils/lockwatch.py``) and its k-curve plotter, held
byte for byte against the JAX package's on the same inputs.

- Spans a port ``Tracer`` records (nesting, a cross-thread attach, events,
  attributes that need coercion) convert to the same Chrome trace JSON,
  ``span_stats`` and ``top_spans`` in both packages, and round-trip the
  JSONL writer of either.
- A scheduler metrics snapshot renders the same Prometheus text (the
  metric registry's help included) and parses back the same.
- The flight recorder's rings and post-mortem dumps, and a timeline's
  JSONL dump, derived rates and flattened metrics, are equal byte for byte.
- ``plot_k_curve`` renders the same PNG through the Agg backend, and
  ``halda_solve(plot=True)`` / ``halda_solve_per_k(plot=True)`` draw the
  curve the reference draws.

No solver runs except the two plot calls (HiGHS, the online golden): ~3 s
in one process.
"""

import json
import threading
import time

import pytest

pytest.importorskip("torch")

from distilp_tpu import obs as jobs  # noqa: E402
from distilp_tpu.sched.metrics import SchedulerMetrics as JMetrics  # noqa: E402
from distilp_tpu.utils import lockwatch as jlockwatch  # noqa: E402

from distilp_torch import obs  # noqa: E402
from distilp_torch.sched.metrics import SchedulerMetrics  # noqa: E402
from distilp_torch.utils import lockwatch  # noqa: E402


def _recorded_spans(tmp_path):
    """Spans of a small traced run in the port: nested spans, events, a
    value that needs coercion, and a worker thread attached to a parent."""
    writer = obs.JsonlSpanWriter(tmp_path / "spans.jsonl")
    tracer = obs.Tracer(capacity=64, writer=writer)
    with tracer.span("sched.tick", attrs={"kind": "degrade", "fleet": "f0"}) as tick:
        with tracer.span("sched.solve") as solve:
            solve.set_attr("lp_backend", "ipm")
            solve.set_attr("weird", {1, 2})
            solve.add_event("solve_retry", attempt=1)
        ctx = tick.context()

        def worker():
            with tracer.attach(ctx):
                with tracer.span("gateway.queue_wait"):
                    time.sleep(0.001)

        t = threading.Thread(target=worker, name="worker-0")
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        with tracer.span("sched.publish", attrs={"mode": "warm", "certified": True}):
            pass
    tracer.close()
    return writer.path


def test_span_exports_equal_the_reference(tmp_path):
    path = _recorded_spans(tmp_path)
    ours, theirs = obs.read_spans(path), jobs.read_spans(path)
    assert ours == theirs and len(ours) == 4
    assert {s["name"] for s in ours} == {"sched.tick", "sched.solve", "gateway.queue_wait",
                                          "sched.publish"}
    assert len({s["trace_id"] for s in ours}) == 1
    assert json.dumps(obs.spans_to_chrome(ours)) == json.dumps(jobs.spans_to_chrome(ours))
    assert obs.span_stats(ours, top=2) == jobs.span_stats(ours, top=2)
    assert obs.top_spans(ours, 3) == jobs.top_spans(ours, 3)
    # The reference's writer reads back in the port too.
    jw = jobs.JsonlSpanWriter(tmp_path / "jax.jsonl")
    for s in ours:
        jw.write(s)
    jw.close()
    assert obs.read_spans(tmp_path / "jax.jsonl") == ours


def test_noop_tracer_and_locks_are_inert():
    assert obs.NOOP_TRACER.span("x").context() is None
    with obs.NOOP_TRACER.span("x") as s:
        s.set_attr("a", 1)
        s.add_event("e")
    lock = lockwatch.make_lock("port.test")
    assert type(lock) is type(jlockwatch.make_lock("port.test"))
    with lock:
        pass


def _metrics(cls):
    m = cls()
    for name, n in (("events_total", 5), ("event_degrade", 3), ("tick_warm", 2),
                    ("spec_hit", 1), ("quarantine_join", 1), ("lp_backend_ipm", 4)):
        m.inc(name, n)
    m.record_tick(mode="warm", certified=True, escalations=0)
    m.record_tick(mode="cold", certified=False, escalations=1)
    for ms in (1.5, 2.25, 40.0, 0.125):
        m.observe("event_to_placement", ms)
        m.observe("drift_tick", ms / 2)
    return m


def test_prometheus_text_equals_the_reference():
    snap, jsnap = _metrics(SchedulerMetrics).snapshot(), _metrics(JMetrics).snapshot()
    assert snap == jsnap
    shards = [{"fleet": 'f"0', "shard": "s0", "worker": 0, "health": "healthy",
               "counters": snap["counters"], "latency": snap["latency"]}]
    kw = dict(gateway_counters={"worker_0_events": 3, "events_routed": 3},
              worker_gauges={"worker_queue_depth": {"0": 2.0}})
    text = obs.render_prometheus(shards, **kw)
    assert text == jobs.render_prometheus(shards, **kw)
    assert obs.parse_prometheus_text(text) == jobs.parse_prometheus_text(text)


def test_flight_dumps_equal_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    recs = [{"seq": i, "kind": "load", "mode": "warm", "health": "healthy",
             "counters_delta": {"tick_warm": 1}} for i in range(5)]
    dumps = []
    for pkg, sub in ((obs, "port"), (jobs, "jax")):
        fr = pkg.FlightRecorder(capacity=3, dump_dir=tmp_path / sub)
        for r in recs:
            fr.record("fleet/0", r)
        assert [r["seq"] for r in fr.snapshot("fleet/0")] == [2, 3, 4]
        path = fr.trigger("fleet/0", "breaker_open", recs[-1])
        assert path.name == "postmortem-fleet_0-001.jsonl"
        dumps.append((path.read_bytes(), fr.snapshot("fleet/0")))
        assert pkg.FlightRecorder(capacity=2).trigger("k", "x") is None
    assert dumps[0] == dumps[1]


def test_timelines_equal_the_reference(tmp_path):
    snap = _metrics(SchedulerMetrics).snapshot()
    flat = obs.flatten_metrics_snapshot(snap)
    assert flat == jobs.flatten_metrics_snapshot(snap)
    lines = []
    for pkg in (obs, jobs):
        tl = pkg.Timeline(capacity=8)
        for i in range(12):
            tl.record_many(100.0 + 0.5 * i, {"c.events_total": 3.0 * i,
                                             "lat.event_to_placement.p99_ms": 10.0 + i % 4})
        lines.append((tl.to_jsonl(), tl.rate("c.events_total", 2.0, 105.5),
                      tl.frac_above("lat.event_to_placement.p99_ms", 11.5, 3.0, 105.5),
                      tl.trend_per_s("lat.event_to_placement.p99_ms", 3.0, 105.5)))
        back = pkg.Timeline.from_jsonl(lines[-1][0])
        assert back.series("c.events_total") == tl.series("c.events_total")
    assert lines[0] == lines[1]


def test_timeline_sampler_counts_samples_and_errors():
    tl = obs.Timeline()
    metrics = SchedulerMetrics()
    calls = {"n": 0}

    def sample():
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("probe failed")
        return {"x": float(calls["n"])}

    sampler = obs.TimelineSampler(tl, sample, period_s=0.01, metrics=metrics)
    for t in (1.0, 2.0, 3.0):
        sampler.sample_once(now=t)
    assert sampler.samples == 2 and sampler.errors == 1
    assert tl.series("x") == [(1.0, 1.0), (3.0, 3.0)]
    assert metrics.counters["timeline_sample_error"] == 1


def test_k_curve_png_equals_the_reference(tmp_path):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    from distilp_tpu.solver.plotter import plot_k_curve as jplot

    from distilp_torch.solver.plotter import plot_k_curve

    curve = [(1, -38.3), (2, -38.0), (4, None), (5, -37.1)]
    plot_k_curve(curve, k_star=1, save_path=str(tmp_path / "port.png"))
    jplot(curve, k_star=1, save_path=str(tmp_path / "jax.png"))
    png = (tmp_path / "port.png").read_bytes()
    assert png[:8] == b"\x89PNG\r\n\x1a\n" and len(png) > 1000
    assert png == (tmp_path / "jax.png").read_bytes()


def test_solves_with_plot_draw_the_reference_curve(profiles_dir, monkeypatch):
    from distilp_tpu.common import load_from_profile_folder as jload
    from distilp_tpu.solver import halda_solve as jsolve
    from distilp_tpu.solver import halda_solve_per_k as jper_k
    from distilp_tpu.solver import plotter as jplotter

    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.solver import halda_solve, halda_solve_per_k, plotter

    drawn = {"port": [], "jax": []}
    monkeypatch.setattr(plotter, "plot_k_curve",
                        lambda objs, k_star=None, **kw: drawn["port"].append((objs, k_star)))
    monkeypatch.setattr(jplotter, "plot_k_curve",
                        lambda objs, k_star=None, **kw: drawn["jax"].append((objs, k_star)))
    folder = profiles_dir / "llama_3_70b" / "online"
    devs, model = load_from_profile_folder(folder)
    jdevs, jmodel = jload(folder)
    kw = dict(mip_gap=1e-4, kv_bits="4bit", backend="cpu", plot=True)
    halda_solve(devs, model, **kw)
    halda_solve_per_k(devs, model, k_candidates=[2, 4], **kw)
    jsolve(jdevs, jmodel, **kw)
    jper_k(jdevs, jmodel, k_candidates=[2, 4], **kw)
    assert len(drawn["port"]) == 2 and [d[1] for d in drawn["port"]] == [2, 2]
    for (ours, k_ours), (theirs, k_theirs) in zip(drawn["port"], drawn["jax"]):
        assert k_ours == k_theirs and [k for k, _ in ours] == [k for k, _ in theirs]
        for (_, a), (_, b) in zip(ours, theirs):
            assert (a is None) == (b is None)
            assert a is None or abs(a - b) <= 2e-4 * abs(b)
