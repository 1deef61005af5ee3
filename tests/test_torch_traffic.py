"""Open-loop traffic in the port (``distilp_torch.traffic``) against the JAX
package's (``distilp_tpu.traffic``), on the CPU. Every comparison is exact.

- ``generate_openloop_schedule`` on two configurations and seeds (the
  recipes of the committed ``tests/traces/openloop_*.jsonl`` captures):
  the same fleet specs and events, and ``write_openloop_trace`` writes the
  same bytes as the reference and as the committed file; the readers agree.
- ``run_openloop`` with the live SLO spec and a sampler period longer
  than the warm-up and the flood: the port's page alert opens (its arm
  samples the pre-incident baseline when the sampler starts); the
  reference's never does (its first sample comes after the flood, with no
  baseline before it: a fault of the reference the port does not copy).
- ``execute_openloop`` over the port's gateway and over the reference's,
  each hosting its package's scheduler stub (``tests/torch_procstub.py``,
  ``tests/procstub.py``) held on a gate so the queue fills
  deterministically: the same sheds, reconciled record by record against
  the flight recorder (``shed_violations`` finds nothing, and catches the
  same tampering); with coalescing on, the same folded batches and no
  shed.

~13 s in one process.
"""

import asyncio
import threading
from pathlib import Path

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_tpu import traffic as jtraffic  # noqa: E402
from distilp_tpu.gateway import Gateway as JGateway  # noqa: E402
from distilp_tpu.obs import FlightRecorder as JFlightRecorder  # noqa: E402
from distilp_tpu.sched.events import LoadTick as JLoadTick  # noqa: E402
from distilp_tpu.traffic.arrivals import ScheduledEvent as JScheduledEvent  # noqa: E402

from distilp_torch import traffic  # noqa: E402
from distilp_torch.gateway import Gateway  # noqa: E402
from distilp_torch.obs import FlightRecorder  # noqa: E402
from distilp_torch.sched.events import LoadTick  # noqa: E402
from distilp_torch.traffic.arrivals import ScheduledEvent  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402
from tests import procstub, torch_procstub  # noqa: E402

# The committed captures' recipes (the reference's tests/test_traffic.py).
RECIPES = {
    "openloop_diurnal_burst.jsonl": (dict(
        seed=7, duration_s=60.0, base_rate=2.0, diurnal_amplitude=0.6,
        diurnal_period_s=40.0, n_regions=3, burst_rate_per_region=0.05,
        burst_factor=3.0, burst_duration_s=8.0, scenario="drift", fleet_size=3,
        fleet_seed=11), 6),
    "openloop_poisson.jsonl": (dict(
        seed=13, duration_s=45.0, base_rate=1.5, scenario="drift", fleet_size=3,
        fleet_seed=11), 4),
}


def _dump(items):
    return [(a, f, e.model_dump()) for a, f, e in items]


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_schedules_and_traces_match_the_reference_byte_for_byte(tmp_path, name):
    cfg, n_fleets = RECIPES[name]
    specs, items = traffic.generate_openloop_schedule(traffic.ArrivalConfig(**cfg), n_fleets)
    jspecs, jitems = jtraffic.generate_openloop_schedule(jtraffic.ArrivalConfig(**cfg),
                                                         n_fleets)
    assert specs == jspecs and _dump(items) == _dump(jitems)
    traffic.write_openloop_trace(tmp_path / "port.jsonl", specs, items)
    jtraffic.write_openloop_trace(tmp_path / "ref.jsonl", jspecs, jitems)
    committed = (Path("tests/traces") / name).read_bytes()
    assert (tmp_path / "port.jsonl").read_bytes() == committed
    assert (tmp_path / "ref.jsonl").read_bytes() == committed
    # The readers agree, and a re-write is byte-stable.
    specs2, items2 = traffic.read_openloop_trace(tmp_path / "port.jsonl")
    jspecs2, jitems2 = jtraffic.read_openloop_trace(tmp_path / "port.jsonl")
    assert specs2 == jspecs2 == specs and _dump(items2) == _dump(jitems2) == _dump(items)
    traffic.write_openloop_trace(tmp_path / "again.jsonl", specs2, items2)
    assert (tmp_path / "again.jsonl").read_bytes() == committed
    assert traffic.is_openloop_trace(tmp_path / "port.jsonl") is True
    gw_trace = "tests/traces/gateway_smoke_10f.jsonl"
    assert traffic.is_openloop_trace(gw_trace) is jtraffic.arrivals.is_openloop_trace(
        gw_trace) is False
    with pytest.raises(ValueError, match="at_s"):
        traffic.read_openloop_trace(gw_trace)


def _gated(stub_module, gate, batches):
    class Gated(stub_module.StubScheduler):
        def handle_coalesced(self, events, pressure=False):
            batches.append(len(events))
            return super().handle_coalesced(events, pressure)

        def handle(self, event, pressure=False):
            gate.wait(timeout=30)
            return super().handle(event, pressure)

    return lambda devices, model: Gated(devices, model)


def _run(port: bool, **admission):
    """Six drift events into one gated shard: the first at once, the other
    five 0.3 s later (the worker has taken the first by then), 20 ms
    apart; the gate opens after the last is offered. Returns (report,
    shed_violations, sheds by fleet, shed flight indices, coalesced batch
    sizes, tamper findings)."""
    gate, batches = threading.Event(), []
    if port:
        flight, stub = FlightRecorder(capacity=64), torch_procstub
        gw = Gateway(n_workers=1, scheduler_factory=_gated(stub, gate, batches),
                     flight=flight, device="cpu", **admission)
        tick, ev, mod = LoadTick, ScheduledEvent, traffic
    else:
        flight, stub = JFlightRecorder(capacity=64), procstub
        gw = JGateway(n_workers=1, scheduler_factory=_gated(stub, gate, batches),
                      flight=flight, **admission)
        tick, ev, mod = JLoadTick, JScheduledEvent, jtraffic
    try:
        gw.register_fleet("f0", make_synthetic_fleet(2, seed=0), None)
        items = [ev(0.3 + 0.02 * i if i else 0.0, "f0",
                    tick(t_comm_jitter={"x": 1.0 + 0.001 * i})) for i in range(6)]
        threading.Timer(1.0, gate.set).start()
        rep = asyncio.run(mod.openloop.execute_openloop(gw, items))
        found = mod.shed_violations(gw, flight)
        indices = [r["shed_index"] for r in flight.snapshot("f0") if r.get("shed")]
        counts = gw.shed_counts()
        gw.metrics.inc("events_shed")  # an unexplained shed must be caught
        tampered = mod.shed_violations(gw, flight)
        return rep, found, counts, indices, list(batches), tampered
    finally:
        gate.set()
        gw.close()


def test_execute_openloop_sheds_like_the_reference_and_reconciles():
    rep, found, counts, indices, _, tampered = _run(True, max_queue_depth=2)
    jrep, jfound, jcounts, jindices, _, jtampered = _run(False, max_queue_depth=2)
    # 1 running + 2 queued; the other three are shed, each flight-recorded.
    assert (rep["offered"], rep["served"], rep["shed"]) == (6, 3, 3)
    assert (jrep["offered"], jrep["served"], jrep["shed"]) == (6, 3, 3)
    assert found == jfound == [] and counts == jcounts == {"f0": 3}
    assert indices == jindices == [1, 2, 3]
    assert rep["shed_samples"] == jrep["shed_samples"]
    assert tampered == jtampered and any("shed accounting" in v for v in tampered)


def test_execute_openloop_coalesces_like_the_reference():
    rep, found, counts, _, batches, _ = _run(True, max_queue_depth=64, coalesce=True)
    jrep, jfound, jcounts, _, jbatches, _ = _run(False, max_queue_depth=64, coalesce=True)
    # The first event runs alone (a batch of one) behind the gate; the five
    # queued behind it fold into one solve, and nothing is shed.
    assert batches == jbatches == [1, 5]
    assert (rep["offered"], rep["served"], rep["shed"]) == (6, 6, 0)
    assert (jrep["offered"], jrep["served"], jrep["shed"]) == (6, 6, 0)
    assert found == jfound == [] and counts == jcounts == {}


def _slo_arm(port: bool):
    """An overload arm with the live SLO spec whose sampler's period (2 s)
    is longer than the whole warm-up and flood: only a baseline taken
    before the flood lets the page alert see the sheds."""
    if port:
        from distilp_torch.obs import SLOConfig
        run, factory, kw = traffic.run_openloop, "tests.torch_procstub:make_scheduler", {
            "device": "cpu"}
    else:
        from distilp_tpu.obs import SLOConfig
        run, factory, kw = jtraffic.run_openloop, "tests.procstub:make_scheduler", {}
    specs, items = traffic.read_openloop_trace("tests/traces/openloop_diurnal_burst.jsonl")
    if not port:
        specs, items = jtraffic.read_openloop_trace("tests/traces/openloop_diurnal_burst.jsonl")
    rep = run(None, specs, items, 1, time_scale=0.001, max_queue_depth=2,
              scheduler_factory=factory, slo_config=SLOConfig.from_json(
                  "tests/traces/slo_live_spec.json"), timeline_period_s=2.0, settle_s=2.5,
              warmup_per_fleet=1, **kw)
    return rep["shed"], [e["state"] for e in rep["slo"]["events"]]


def test_the_alert_sees_a_flood_shorter_than_one_sampler_period():
    # The port samples the pre-incident baseline when the arm's sampler
    # starts; the reference's first sample comes one period later, after
    # this flood, and its page alert never opens (a fault of the reference
    # the port does not copy).
    shed, states = _slo_arm(True)
    jshed, jstates = _slo_arm(False)
    assert shed > 0 and jshed > 0
    assert states[:1] == ["open"]
    assert jstates == []
