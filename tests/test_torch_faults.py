"""Chaos hardening in the port (``distilp_torch/sched/faults.py`` and the
scheduler's guards) against the JAX package's, on the CPU.

- Fault plans (the bundled ``chaos_plan.json`` and a seeded probabilistic
  one) give the same schedules, the same injected events and the same
  ``validate_event`` verdicts in both packages.
- The retry ladder, the circuit breaker (open, half-open probe, re-open,
  close) and the deadline (a miss served stale, the abandoned solve
  drained, health recovered) are driven through the scheduler's
  ``fault_hook`` seam, as the reference's tests drive them; the deadline
  miss is forced by a hook that blocks on an event, not by a sleep that
  races the solve.
- The same chaos replay (8 trace events, every fault kind) through both
  daemons: the same records, injected counts, quarantine and breaker
  counters, served placements (objectives within the gap), and no
  violation of the soak contract; ``dump_state`` drains an abandoned solve
  first.

~30 s in one process.
"""

import threading

import pytest

torch = pytest.importorskip("torch")

from distilp_tpu import sched as jsched  # noqa: E402
from distilp_tpu.common import load_model_profile as jload_model  # noqa: E402
from distilp_tpu.utils import make_synthetic_fleet as jfleet  # noqa: E402

from distilp_torch import sched  # noqa: E402
from distilp_torch.common import load_model_profile  # noqa: E402
from distilp_torch.sched import FaultPlan, FaultSpec  # noqa: E402
from distilp_torch.utils import make_synthetic_fleet  # noqa: E402

GAP = 1e-3
KS = [8, 10]
ONLINE = "tests/profiles/llama_3_70b/online/model_profile.json"
PLAN = "tests/traces/chaos_plan.json"


@pytest.fixture(scope="module")
def model():
    return load_model_profile(ONLINE)


@pytest.fixture(scope="module")
def jmodel():
    return jload_model(ONLINE)


def make_scheduler(model, **kw):
    kw.setdefault("mip_gap", GAP)
    kw.setdefault("kv_bits", "4bit")
    kw.setdefault("k_candidates", KS)
    kw.setdefault("device", "cpu")
    return sched.Scheduler(make_synthetic_fleet(4, seed=11), model, **kw)


def _probabilistic_plan(pkg):
    return pkg.FaultPlan(seed=42, faults=[
        pkg.FaultSpec(kind="solver_exception", p=0.25, start=0, end=50),
        pkg.FaultSpec(kind="nan_poison", p=0.1, start=10, end=40),
        pkg.FaultSpec(kind="malformed_event", p=0.1, start=0, end=50),
        pkg.FaultSpec(kind="dropout_burst", at_ticks=[7, 31]),
    ])


def test_fault_schedules_and_events_equal_the_reference(model, jmodel):
    for ours, theirs in ((FaultPlan.from_json(PLAN), jsched.FaultPlan.from_json(PLAN)),
                         (_probabilistic_plan(sched), _probabilistic_plan(jsched))):
        assert ours.model_dump() == theirs.model_dump()
        inj, jinj = sched.FaultInjector(ours), jsched.FaultInjector(theirs)
        assert inj.schedule(50) == jinj.schedule(50) and inj.schedule(50)
        fleet = sched.FleetState(make_synthetic_fleet(4, seed=11), model)
        jfleet_ = jsched.FleetState(jfleet(4, seed=11), jmodel)
        for tick in range(50):
            specs, jspecs = inj.faults_at(tick), jinj.faults_at(tick)
            assert [(i, s.model_dump()) for i, s in specs] == [
                (i, s.model_dump()) for i, s in jspecs]
            evs = inj.event_faults(tick, specs, fleet)
            jevs = jinj.event_faults(tick, jspecs, jfleet_)
            assert [(k, e.kind, repr(e.model_dump())) for k, e in evs] == [
                (k, e.kind, repr(e.model_dump())) for k, e in jevs]


class _Hook:
    """The reference's controllable fault_hook: fails attempts while
    ``failing``; with ``gate`` set, blocks each attempt until released."""

    def __init__(self, transient=False):
        self.failing = False
        self.transient = transient
        self.calls = 0
        self.gate = None

    def __call__(self, attempt):
        self.calls += 1
        if self.gate is not None:
            assert self.gate.wait(timeout=60)
        if self.failing and not (self.transient and attempt > 0):
            raise RuntimeError("injected by _Hook")


def test_retry_ladder_saves_transient_faults(model):
    hook = _Hook(transient=True)
    s = make_scheduler(model, max_retries=2, retry_backoff_s=0.001, fault_hook=hook)
    s.handle(sched.LoadTick(t_comm_jitter={}))
    hook.failing = True
    view = s.handle(sched.DeviceDegrade(name=s.fleet.device_list()[1].name,
                                        t_comm_scale=1.1))
    assert view.events_behind == 0
    c = s.metrics.counters
    assert c["solve_retries"] == 1 and c["solve_retry_success"] == 1
    assert c["tick_failed"] == 0


def test_breaker_open_half_open_close(model):
    hook = _Hook()
    s = make_scheduler(model, breaker_threshold=2, breaker_cooldown=2, healthy_after=2,
                       fault_hook=hook)
    tick = sched.LoadTick(t_comm_jitter={})
    s.handle(tick)
    c = s.metrics.counters
    hook.failing = True
    s.handle(tick)
    assert s.health == sched.HEALTH_DEGRADED
    s.handle(tick)
    assert c["breaker_open"] == 1 and s.health == sched.HEALTH_BROKEN
    calls = hook.calls
    v1, v2 = s.handle(tick), s.handle(tick)
    assert hook.calls == calls and c["breaker_short_circuit"] == 2
    assert v1.mode == v2.mode == "degraded" and v2.events_behind > 0
    s.handle(tick)
    assert c["breaker_half_open_probe"] == 1 and c["breaker_reopen"] == 1
    hook.failing = False
    s.handle(tick)
    s.handle(tick)
    assert c["breaker_short_circuit"] == 4
    probe = s.handle(tick)
    assert c["breaker_half_open_probe"] == 2 and c["breaker_close"] == 1
    assert probe.events_behind == 0 and s.health == sched.HEALTH_DEGRADED
    s.handle(tick)
    assert s.health == sched.HEALTH_HEALTHY
    snap = s.health_snapshot()
    assert snap["state"] == "healthy" and snap["breaker_open"] is False


def test_deadline_miss_serves_stale_and_recovers(model):
    hook = _Hook()
    s = make_scheduler(model, solve_deadline_s=2.0, fault_hook=hook)
    first = s.handle(sched.LoadTick(t_comm_jitter={}))  # the first solve is exempt
    assert first.events_behind == 0
    # The next attempt blocks in its hook until released: the deadline
    # passes with the solve still running on the worker thread.
    hook.gate = threading.Event()
    view = s.handle(sched.DeviceDegrade(name=s.fleet.device_list()[1].name,
                                        t_comm_scale=1.05))
    assert view.mode == "stale" and view.events_behind == 1
    c = s.metrics.counters
    assert c["deadline_missed"] == 1 and s.health == sched.HEALTH_DEGRADED
    assert s.latest().mode == "stale"
    # Released, the abandoned solve finishes; the next tick drains it first.
    hook.gate.set()
    for _ in range(4):
        view = s.handle(sched.LoadTick(t_comm_jitter={}))
    assert view.events_behind == 0 and view.mode in ("warm", "cold")
    assert c["abandoned_solves_drained"] >= 1 and s.health == sched.HEALTH_HEALTHY
    s.close()


def test_dump_state_drains_an_abandoned_solve(model):
    hook = _Hook()
    s = make_scheduler(model, solve_deadline_s=2.0, fault_hook=hook)
    s.handle(sched.LoadTick(t_comm_jitter={}))
    hook.gate = threading.Event()
    assert s.handle(sched.LoadTick(t_comm_jitter={})).mode == "stale"
    threading.Timer(0.05, hook.gate.set).start()
    blob = s.dump_state()
    assert s.metrics.counters["abandoned_solves_drained"] == 1 and s._abandoned is None
    assert blob["pool"] and blob["published"]["mode"] == "stale"
    s.close()


def _views_key(views):
    return [(v.mode, v.result.k, tuple(v.result.w), tuple(v.result.n)) for v in views]


def test_chaos_replay_matches_the_reference(model, jmodel):
    events = sched.read_trace("tests/traces/scheduler_smoke_20.jsonl")[:8]
    jevents = jsched.read_trace("tests/traces/scheduler_smoke_20.jsonl")[:8]
    specs = [dict(kind="solver_exception", at_ticks=[2], transient=True),
             dict(kind="solver_exception", at_ticks=[4, 5]),
             dict(kind="latency_spike", at_ticks=[6], spike_s=0.01),
             dict(kind="nan_poison", at_ticks=[3]),
             dict(kind="malformed_event", at_ticks=[1]),
             dict(kind="dropout_burst", at_ticks=[5], rejoin_after=2)]
    kw = dict(mip_gap=GAP, kv_bits="4bit", k_candidates=KS, max_retries=1,
              retry_backoff_s=0.001, breaker_threshold=2)
    ours = sched.chaos_replay(
        sched.Scheduler(make_synthetic_fleet(4, seed=11), model, device="cpu", **kw), events,
        FaultPlan(seed=7, faults=[FaultSpec(**f) for f in specs]))
    theirs = jsched.chaos_replay(
        jsched.Scheduler(jfleet(4, seed=11), jmodel, backend="jax", **kw), jevents,
        jsched.FaultPlan(seed=7, faults=[jsched.FaultSpec(**f) for f in specs]))
    assert ours.injected == theirs.injected and ours.injected["injected_total"] >= 6
    assert [(r.source, r.kind, r.quarantined) for r in ours.records] == [
        (r.source, r.kind, r.quarantined) for r in theirs.records]
    assert [v[0] for v in _views_key(ours.views)] == [v[0] for v in _views_key(theirs.views)]
    for v, jv in zip(ours.views, theirs.views):
        if _views_key([v]) != _views_key([jv]):
            b = jv.result.obj_value
            assert abs(v.result.obj_value - b) <= GAP * abs(b)
    assert ours.summary() == theirs.summary()
    assert ours.violations(model.L) == theirs.violations(jmodel.L) == []
