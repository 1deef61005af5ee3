"""The port's scheduler daemon (``distilp_torch/sched``) against the JAX
package's (``distilp_tpu/sched``), on the CPU.

The instance is the reference's smoke fleet: Llama-3-70B online on
``make_synthetic_fleet(4, seed=11)``, k in {8, 10}, gap 1e-3, kv 4bit, with
traces of at most 8 events.

- Events, traces (every scenario of ``generate_trace``, the JSONL format of
  either package), fleet digests and the quarantine checks are equal.
- The same mixed trace (a join among drift events) through
  ``Scheduler(backend="jax")`` and the port's ``Scheduler(device="cpu")``:
  the same mode per tick, the same served (k, w, n) or objectives within
  the gap, the same routing, pool and certification counters.
- A JAX-dumped ``dump_state`` blob resumes warm in the port
  (``interop.scheduler_state_from_jax``), and the port's own blob round-trips.
- The port's copies of the risk-aware tests (the served placement changes
  on the bundled trace's first event; replays are deterministic) and of
  the MoE margin test pass.
- Without a GPU the scheduler raises unless the caller asks for the CPU,
  and a profiled first tick writes a ``torch.profiler`` trace.

~60 s in one process (the JAX side's compiles come from the persistent
cache; the Mixtral margin test ~20 s of it).
"""

import json

import pytest

torch = pytest.importorskip("torch")

from distilp_tpu import sched as jsched  # noqa: E402
from distilp_tpu.common import load_model_profile as jload_model  # noqa: E402
from distilp_tpu.utils import make_synthetic_fleet as jfleet  # noqa: E402

from distilp_torch import sched  # noqa: E402
from distilp_torch.common import load_model_profile  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

GAP = 1e-3
KS = [8, 10]
ONLINE = "tests/profiles/llama_3_70b/online/model_profile.json"
SMOKE_TRACE = "tests/traces/scheduler_smoke_20.jsonl"


@pytest.fixture(scope="module")
def model():
    return load_model_profile(ONLINE)


@pytest.fixture(scope="module")
def jmodel():
    return jload_model(ONLINE)


def port_scheduler(model, **kw):
    kw.setdefault("mip_gap", GAP)
    kw.setdefault("kv_bits", "4bit")
    kw.setdefault("k_candidates", KS)
    kw.setdefault("device", "cpu")
    return sched.Scheduler(make_synthetic_fleet(4, seed=11), model, **kw)


def jax_scheduler(jmodel, **kw):
    kw.setdefault("mip_gap", GAP)
    kw.setdefault("kv_bits", "4bit")
    kw.setdefault("k_candidates", KS)
    return jsched.Scheduler(jfleet(4, seed=11), jmodel, backend="jax", **kw)


def _dumps(events):
    return [json.dumps({"kind": e.kind, **e.model_dump()}, sort_keys=True) for e in events]


@pytest.mark.parametrize("scenario", sorted(jsched.sim.SCENARIOS))
def test_traces_equal_the_reference(tmp_path, scenario):
    ours = sched.generate_trace(scenario, 8, seed=23, base_fleet=make_synthetic_fleet(4, 11))
    theirs = jsched.generate_trace(scenario, 8, seed=23, base_fleet=jfleet(4, seed=11))
    assert _dumps(ours) == _dumps(theirs)
    sched.write_trace(tmp_path / "port.jsonl", ours)
    jsched.write_trace(tmp_path / "jax.jsonl", theirs)
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()
    assert _dumps(sched.read_trace(tmp_path / "jax.jsonl")) == _dumps(theirs)


def test_fleet_digests_and_quarantine_checks_equal(model, jmodel):
    events = sched.read_trace(SMOKE_TRACE)
    jevents = jsched.read_trace(SMOKE_TRACE)
    ours = sched.FleetState(make_synthetic_fleet(4, seed=11), model)
    theirs = jsched.FleetState(jfleet(4, seed=11), jmodel)
    for ev, jev in zip(events, jevents):
        assert sched.is_structural(ev) == jsched.is_structural(jev)
        assert ours.apply(ev) == theirs.apply(jev)
        assert ours.key() == theirs.key() and ours.seq == theirs.seq
        assert [d.model_dump() for d in ours.device_list()] == [
            d.model_dump() for d in theirs.device_list()]
    from distilp_tpu.sched.events import validate_event as jvalidate

    from distilp_torch.sched.events import validate_event

    bad = [sched.DeviceDegrade(name="x", t_comm_scale=float("nan")),
           sched.DeviceDegrade(name="x", mem_scale=-0.1),
           sched.LoadTick(t_comm_jitter={"a": float("inf")}),
           sched.LoadTick(expert_loads=[0.0, 0.0]),
           sched.DeviceLeave(name="x"), sched.LoadTick(t_comm_jitter={"a": 0.97})]
    for ev in bad:
        jev = jsched.event_from_dict({"kind": ev.kind, **ev.model_dump()})
        assert validate_event(ev) == jvalidate(jev)


def _served(view):
    r = view.result
    return view.mode, r.k, tuple(r.w), tuple(r.n), r.certified


def test_scheduler_ticks_match_the_reference(model, jmodel):
    """One mixed trace (drift, then a join, then drift) through both
    daemons: same modes, placements, certificates and counters."""
    events = sched.generate_trace("mixed", 8, seed=23, base_fleet=make_synthetic_fleet(4, 11))
    jevents = jsched.generate_trace("mixed", 8, seed=23, base_fleet=jfleet(4, seed=11))
    ours, theirs = port_scheduler(model), jax_scheduler(jmodel)
    rep, jrep = sched.replay(ours, events), jsched.replay(theirs, jevents)
    assert rep.failed_ticks == jrep.failed_ticks == 0
    assert rep.structural_uncertified == jrep.structural_uncertified == 0
    assert any(sched.is_structural(e) for e in events)
    for v, jv in zip(rep.views, jrep.views):
        assert _served(v)[0] == _served(jv)[0]
        if _served(v) != _served(jv):
            b = jv.result.obj_value
            assert abs(v.result.obj_value - b) <= GAP * abs(b), (_served(v), _served(jv))
        assert v.events_behind == jv.events_behind == 0 and v.key == jv.key
    c, jc = ours.metrics.counters, theirs.metrics.counters
    for name in ("events_total", "structural_events", "drift_events", "pool_hit",
                 "pool_miss", "tick_cold", "tick_warm", "tick_margin", "tick_certified",
                 "tick_uncertified", "structural_tick_cold", "drift_tick_warm",
                 "lp_backend_ipm"):
        assert c.get(name, 0) == jc.get(name, 0), name
    assert sched.drift_warm_share(ours.metrics) == jsched.drift_warm_share(theirs.metrics)
    assert set(ours.metrics_snapshot()) == set(theirs.metrics_snapshot())


def test_jax_state_resumes_warm_in_the_port(model, jmodel):
    from distilp_torch.interop import scheduler_state_from_jax

    events = sched.read_trace(SMOKE_TRACE)[:4]
    jevents = jsched.read_trace(SMOKE_TRACE)[:4]
    theirs = jax_scheduler(jmodel, speculative=True)
    for ev in jevents[:3]:
        theirs.handle(ev)
    blob = json.loads(json.dumps(theirs.dump_state()))
    state = scheduler_state_from_jax(blob)
    assert state["pool"] and all(e["warm"]["ipm_state"] is not None for e in state["pool"])
    ours = port_scheduler(model, speculative=True)
    ours.load_state(state)
    assert ours.latest().result.model_dump() == theirs.latest().result.model_dump()
    assert ours.fleet.key() == theirs.fleet.key() and ours.fleet.seq == theirs.fleet.seq
    assert len(ours.spec_bank) == len(theirs.spec_bank)
    view = ours.handle(events[3])
    jview = theirs.handle(jevents[3])
    assert ours.metrics.counters["warm_resumes"] == 1
    assert view.mode in ("warm", "margin") and view.result.certified
    b = jview.result.obj_value
    assert abs(view.result.obj_value - b) <= GAP * abs(b)
    # The port's own snapshot round-trips: same blob after a reload.
    again = port_scheduler(model, speculative=True)
    again.load_state(json.loads(json.dumps(ours.dump_state())))
    assert json.dumps(again.dump_state(), sort_keys=True) == json.dumps(
        ours.dump_state(), sort_keys=True)
    with pytest.raises(ValueError, match="version"):
        scheduler_state_from_jax({**blob, "version": 2})


def test_risk_aware_changes_served_placement_on_bundled_trace(model):
    """The port's copy of the reference's test: on the bundled trace's first
    event the objective prefers k=10 by a hair, the twin's straggler
    channel the shallower k=8."""
    events = sched.read_trace(SMOKE_TRACE)[:1]
    served, metrics = {}, {}
    for risk in (False, True):
        s = port_scheduler(model, risk_aware=risk)
        views = [s.handle(ev) for ev in events]
        served[risk] = [(v.result.k, tuple(v.result.w)) for v in views]
        metrics[risk] = s.metrics.counters
        if risk:
            assert all(v.twin_p95_s is not None for v in views)
            assert any(v.risk_selected for v in views)
    assert served[True] != served[False]
    assert metrics[True]["risk_eval"] == len(events)
    assert metrics[True]["risk_switch"] >= 1
    assert metrics[True]["risk_error"] == 0
    assert "risk_eval" not in metrics[False]


def test_risk_aware_deterministic_replay(model):
    events = sched.read_trace(SMOKE_TRACE)[:4]
    runs = []
    for _ in range(2):
        s = port_scheduler(model, risk_aware=True, risk_samples=128)
        runs.append([(v.result.k, tuple(v.result.w), v.twin_p95_s, v.mode)
                     for v in (s.handle(ev) for ev in events)])
    assert runs[0] == runs[1]


def test_moe_drift_ticks_ride_margin_path():
    """The port's copy of the reference's MoE test: drift ticks of a Mixtral
    identity engage the margin path (K7's bounds reused, K2 MoE)."""
    from distilp_torch.profiler import profile_model

    moe_model = profile_model("tests/configs/mixtral_8x7b.json", batch_sizes=[1],
                              sequence_length=128).to_model_profile()
    devs = make_synthetic_fleet(4, seed=7, pool_bytes=int(64e9))
    s = sched.Scheduler(devs, moe_model, mip_gap=GAP, kv_bits="8bit", device="cpu")
    names = [d.name for d in devs]
    first = s.handle(sched.DeviceDegrade(name=names[1], t_comm_scale=1.01))
    assert first.result.certified and first.result.y is not None
    for scale in (1.03, 0.98):
        view = s.handle(sched.DeviceDegrade(name=names[2], t_comm_scale=scale))
        assert view.result.certified and view.mode == "margin"
    c = s.metrics.counters
    assert c["drift_tick_margin"] == 2 and c["tick_margin"] == 2
    assert sched.drift_warm_share(s.metrics) == pytest.approx(2 / 3)


def test_scheduler_needs_a_gpu_unless_asked_for_the_cpu(model, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = sched.Scheduler(make_synthetic_fleet(4, seed=11), model, mip_gap=GAP, kv_bits="4bit",
                        k_candidates=KS)
    with pytest.raises(RuntimeError, match="CUDA device"):
        s.handle(sched.LoadTick(t_comm_jitter={}))
    with pytest.raises(ValueError, match="backend"):
        sched.Scheduler(make_synthetic_fleet(4, seed=11), model, backend="jax")
    # A profiled first tick on the CPU writes its torch.profiler trace.
    s = port_scheduler(model, profile_dir=str(tmp_path / "prof"))
    assert s.handle(sched.LoadTick(t_comm_jitter={})).result.certified
    trace = json.loads((tmp_path / "prof" / "solve_profile.json").read_text())
    assert trace["traceEvents"]
