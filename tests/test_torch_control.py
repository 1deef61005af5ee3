"""The autoscaler in the port (``distilp_torch.control``) against the JAX
package's (``distilp_tpu.control``), on the CPU. Every comparison is exact.

- ``Controller.replay`` over the committed overload timeline, policy and
  SLO spec: the port's action JSONL equals the reference's, and at the
  committed step ``tests/traces/control_expected_actions.jsonl``, byte for
  byte (other steps, no spec, and a pinned capacity too).
- ``Controller.step`` over one sequence of synthetic ``/signals``
  payloads (depth, page alerts, headroom, memory, trend, recovery): the
  same actions, counters and flight records as the reference.
- ``ControlLoop`` on the port's dynamic gateway hosting
  ``tests/torch_procstub.py``'s scheduler stub, and on the reference's with
  ``tests/procstub.py``'s: the same scale-out and scale-in through
  ``spawn_worker``/``retire_worker``, reconciled against the counters and
  the flight trail.
- An open-loop arm whose scale-out takes longer than the control loop's
  default join (a child's start on the H100's host takes 8-12 s): its report
  waits for the actuation, and the trail reconciles.

~11 s in one process.
"""

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_tpu import control as jcontrol  # noqa: E402
from distilp_tpu import obs as jobs  # noqa: E402
from distilp_tpu.gateway import Gateway as JGateway  # noqa: E402
from distilp_tpu.gateway.traces import make_fleet_from_spec as jmake_fleet  # noqa: E402
from distilp_tpu.obs import slo as jslo  # noqa: E402
from distilp_tpu.sched.metrics import SchedulerMetrics as JMetrics  # noqa: E402

from distilp_torch import control, obs  # noqa: E402
from distilp_torch.gateway import Gateway  # noqa: E402
from distilp_torch.gateway.traces import make_fleet_from_spec  # noqa: E402
from distilp_torch.obs import slo  # noqa: E402
from distilp_torch.sched.metrics import SchedulerMetrics  # noqa: E402

TRACES = "tests/traces"


@pytest.mark.parametrize("step_s, spec, capacity", [
    (0.5, True, None), (0.25, True, None), (0.5, False, None), (1.0, True, 40.0),
], ids=["committed", "step0.25", "no-spec", "capacity"])
def test_replay_matches_the_reference_and_the_fixture(step_s, spec, capacity):
    out = []
    for ctl, o in ((control, obs), (jcontrol, jobs)):
        tl = o.Timeline.load(f"{TRACES}/slo_timeline_overload.jsonl")
        pol = ctl.ControlPolicy.from_json(f"{TRACES}/control_policy.json")
        cfg = o.SLOConfig.from_json(f"{TRACES}/slo_overload_spec.json") if spec else None
        out.append(ctl.actions_to_jsonl(ctl.Controller.replay(
            tl, pol, slo_config=cfg, step_s=step_s, capacity_eps=capacity)))
    assert out[0] == out[1] and out[0]
    if (step_s, spec, capacity) == (0.5, True, None):
        assert out[0] == open(f"{TRACES}/control_expected_actions.jsonl").read()


def _signals(s, depth=0.0, n=1, page=False, headroom=None, capacity=None, mem=None,
             trend=None, recovery=None):
    slos = [s.SLOBurnSignal(slo="lat", budget=0.05, burn={}, firing=["page"])] if page else []
    return s.SignalsPayload(
        workers=[s.WorkerSignal(worker=i, queue_depth=depth / n,
                                queue_depth_trend_per_s=trend) for i in range(n)],
        queue_depth_total=depth, slos=slos, alerts_open=int(page),
        max_sustainable_eps=capacity, headroom_eps=headroom, mem_headroom_bytes=mem,
        recovery=recovery)


# (now, n_workers, signal keywords): hot, held, paged, memory-starved,
# trending, quarantining, then calm long enough to scale back in.
SEQUENCE = [
    (1.0, 1, dict(depth=16.0)), (2.0, 2, dict(depth=20.0, n=2)),
    (15.0, 2, dict(page=True, n=2)), (16.0, 3, dict(n=3, mem=1e6)),
    (30.0, 3, dict(n=3, depth=3.0, trend=5.0, headroom=-5.0, capacity=50.0)),
    (45.0, 3, dict(n=3, recovery={"workers_quarantined": 1})),
    (60.0, 3, dict(n=3)), (63.0, 3, dict(n=3)), (67.0, 3, dict(n=3)), (80.0, 2, dict(n=2)),
]


def test_step_matches_the_reference_action_for_action():
    kw = dict(min_workers=1, max_workers=4, scale_cooldown_s=10.0, headroom_min_frac=0.1,
              depth_high_per_worker=8.0, calm_hold_s=5.0)
    runs = []
    for ctl, s, metrics, o in ((control, slo, SchedulerMetrics(), obs),
                               (jcontrol, jslo, JMetrics(), jobs)):
        c, flight = ctl.Controller(ctl.ControlPolicy(**kw)), o.FlightRecorder(capacity=64)
        acts = []
        for now, n, sk in SEQUENCE:
            acts += [a.model_dump() for a in c.step(_signals(s, **sk), now=now, n_workers=n,
                                                     metrics=metrics, flight=flight)]
        runs.append((acts, dict(metrics.counters), flight.snapshot("control")))
    assert runs[0] == runs[1]
    kinds = [a["kind"] for a in runs[0][0]]
    assert "scale_out" in kinds and "scale_in" in kinds and "degrade_on" in kinds


def _loop_run(port: bool):
    if port:
        gw = Gateway(n_workers=1, scheduler_factory="tests.torch_procstub:make_scheduler",
                     dynamic=True, flight=obs.FlightRecorder(capacity=64), device="cpu")
        ctl, o, mk = control, obs, make_fleet_from_spec
    else:
        gw = JGateway(n_workers=1, scheduler_factory="tests.procstub:make_scheduler",
                      dynamic=True, flight=jobs.FlightRecorder(capacity=64))
        ctl, o, mk = jcontrol, jobs, jmake_fleet
    try:
        for i in range(4):
            fid = f"c{i:02d}"
            gw.register_fleet(fid, mk(fid, {"m": 3, "seed": 900 + i}), "stub")
        tl = o.Timeline()
        gw.attach_slo(None, tl)
        loop = ctl.ControlLoop(gw, ctl.Controller(ctl.ControlPolicy(
            min_workers=1, max_workers=2, scale_cooldown_s=0.0, headroom_min_frac=None,
            depth_high_per_worker=8.0, calm_hold_s=4.0)))
        tl.record("queue_depth.w0", 10.0, 16.0)
        trail = [[a.kind for a in loop.step(now=10.0)], list(gw.live_worker_ids())]
        seqs = [gw.handle_event(fid, "post-spawn")["seq"] for fid in sorted(gw._fleet_key)]
        for t in (20.0, 22.0, 25.0):
            tl.record_many(t, {"queue_depth.w0": 0.0, "queue_depth.w1": 0.0})
            acts = loop.step(now=t)
        trail += [[a.kind for a in acts], list(gw.live_worker_ids())]
        seqs += [gw.handle_event(fid, "post-retire")["seq"] for fid in sorted(gw._fleet_key)]
        c = gw.metrics.snapshot()["counters"]
        counters = {k: c.get(k, 0) for k in ("control_actions", "control_scale_out",
                                             "control_scale_in", "workers_spawned",
                                             "workers_retired", "migration_failed")}
        flight = [r["action"]["kind"] for r in gw.flight.snapshot("control")]
        return trail, seqs, counters, flight, loop.errors, tl.latest("control.workers")[1]
    finally:
        gw.close()


def test_control_loop_actuates_the_ports_gateway_like_the_reference():
    got, want = _loop_run(True), _loop_run(False)
    assert got == want
    trail, seqs, counters, flight, errors, workers = got
    assert trail == [["scale_out"], [0, 1], ["scale_in"], [0]]
    assert seqs == [1] * 4 + [2] * 4 and errors == 0 and workers == 1.0
    assert counters["control_actions"] == 2 and counters["migration_failed"] == 0
    assert counters["control_scale_out"] == counters["workers_spawned"] == 1
    assert counters["control_scale_in"] == counters["workers_retired"] == 1
    assert flight == ["scale_out", "scale_in"]


def test_an_arm_waits_for_a_scale_out_in_flight(monkeypatch):
    # A spawn slower than the control loop's default 5 s join (a child's
    # start on the H100's host takes 8-12 s): the arm's report still holds
    # the whole trail, reconciled against the counters and the flight.
    import time

    from distilp_torch import traffic

    spawn = Gateway.spawn_worker

    def slow_spawn(self):
        time.sleep(6.0)
        return spawn(self)

    monkeypatch.setattr(Gateway, "spawn_worker", slow_spawn)
    specs, items = traffic.read_openloop_trace("tests/traces/openloop_diurnal_burst.jsonl")
    rep = traffic.run_openloop(
        None, specs, items, 1, time_scale=0.001, max_queue_depth=2, device="cpu",
        scheduler_factory="tests.torch_procstub:make_scheduler", warmup_per_fleet=1,
        slo_config=obs.SLOConfig.from_json(f"{TRACES}/slo_live_spec.json"),
        autoscale=control.ControlPolicy.from_json(f"{TRACES}/control_live_policy.json"),
        control_period_s=0.05, settle_s=0.5, flight=obs.FlightRecorder(capacity=512))
    ctl = rep["control"]
    assert ("scale_out", 2) in [(a["kind"], a["target_workers"]) for a in ctl["actions"]]
    assert ctl["violations"] == [] and ctl["workers_final"] == 2
