"""Speculative replanning in the port (``distilp_torch/sched/forecast.py``,
``speculate.py``) against the JAX package's, on the CPU.

- The forecaster's state and candidate futures, the instance digests and
  tolerance buckets, and the bank's snapshot blob are equal, bit for bit,
  on the same applied event stream (Llama-3-70B online on
  ``make_synthetic_fleet(4, seed=11)``).
- The port's speculation batch is one ``halda_solve_scenarios`` call: its
  K futures are the lanes of one search (their static halves equal under
  t_comm drift, so one shared A), warm-seeded from the incumbent, each
  lane within the gap of its own solve.
- The bundled burst trace's first 8 events through both daemons with
  ``speculative=True``: the same hit/miss sequence, banked entries and
  served placements (objectives within the gap).
- Speculation off is inert; a hit donates the banked solve as the pooled
  replanner's warm seed; the bank rides ``dump_state`` bit for bit.

~25 s in one process.
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
BURST = "tests/traces/spec_burst.jsonl"


@pytest.fixture(scope="module")
def model():
    return load_model_profile(ONLINE)


@pytest.fixture(scope="module")
def jmodel():
    return jload_model(ONLINE)


def _devs(devs):
    return [d.model_dump() for d in devs]


def test_forecasts_and_digests_equal_the_reference(model, jmodel):
    ours = sched.FleetState(make_synthetic_fleet(4, seed=11), model)
    theirs = jsched.FleetState(jfleet(4, seed=11), jmodel)
    fc, jfc = sched.ChurnForecaster(), jsched.ChurnForecaster()
    fc.observe(ours)
    jfc.observe(theirs)
    events = sched.read_trace(BURST)[:12] + sched.generate_trace(
        "decay", 6, seed=3, base_fleet=make_synthetic_fleet(4, seed=11))
    for ev in events:
        jev = jsched.event_from_dict({"kind": ev.kind, **ev.model_dump()})
        ours.apply(ev)
        theirs.apply(jev)
        fc.observe(ours)
        jfc.observe(theirs)
        assert fc.dump_state() == jfc.dump_state()
        for tol in (0.05, 0.2):
            assert sched.instance_digest(ours, tol) == jsched.instance_digest(theirs, tol)
            assert sched.bucket_vector(ours.device_list(), model, tol) == \
                jsched.bucket_vector(theirs.device_list(), jmodel, tol)
        got, want = fc.forecast(ours, 3), jfc.forecast(theirs, 3)
        assert [w for _, w in got] == [w for _, w in want]
        assert [_devs(d) for d, _ in got] == [_devs(d) for d, _ in want]
        for (d, _), (jd, _) in zip(got, want):
            assert sched.candidate_digest(d, model, ours.key(), 0.05) == \
                jsched.candidate_digest(jd, jmodel, theirs.key(), 0.05)


def test_presolve_is_one_lane_batch_within_the_gap(model, monkeypatch):
    import distilp_torch.solver as solver
    from distilp_torch.sched.speculate import presolve_candidates
    from distilp_torch.solver import halda_solve

    fs = sched.FleetState(make_synthetic_fleet(4, seed=11), model)
    fc = sched.ChurnForecaster()
    fc.observe(fs)
    for ev in sched.read_trace(BURST)[:3]:
        fs.apply(ev)
        fc.observe(fs)
    warm = halda_solve(fs.device_list(), model, k_candidates=KS, mip_gap=GAP, kv_bits="4bit",
                       device="cpu")
    cands = fc.forecast(fs, 3)
    tm = {"calls": 0}
    orig = solver.halda_solve_scenarios

    def counted(*a, **kw):
        tm["calls"] += 1
        return orig(*a, timings=tm, **kw)

    monkeypatch.setattr(solver, "halda_solve_scenarios", counted)
    got = presolve_candidates(cands, model, k_candidates=KS, mip_gap=GAP, kv_bits="4bit",
                              moe=None, warm=warm, device="cpu")
    assert tm["calls"] == 1 and not tm.get("scenario_fallback")
    assert len(got) == len(cands) == 3
    for (devs, _), r in zip(cands, got):
        ref = halda_solve(devs, model, k_candidates=KS, mip_gap=GAP, kv_bits="4bit",
                          device="cpu")
        assert r.certified
        assert abs(r.obj_value - ref.obj_value) <= 2 * GAP * abs(ref.obj_value)


def test_speculative_replay_matches_the_reference(model, jmodel):
    events = sched.read_trace(BURST)[:8]
    jevents = jsched.read_trace(BURST)[:8]
    kw = dict(mip_gap=GAP, kv_bits="4bit", k_candidates=KS, speculative=True)
    ours = sched.Scheduler(make_synthetic_fleet(4, seed=11), model, device="cpu", **kw)
    theirs = jsched.Scheduler(jfleet(4, seed=11), jmodel, backend="jax", **kw)
    modes, jmodes = [], []
    for ev, jev in zip(events, jevents):
        v, jv = ours.handle(ev), theirs.handle(jev)
        modes.append(v.mode)
        jmodes.append(jv.mode)
        b = jv.result.obj_value
        assert abs(v.result.obj_value - b) <= GAP * abs(b)
        assert v.result.certified and jv.result.certified
    assert modes == jmodes and "spec" in modes
    snap, jsnap = ours.speculation_snapshot(), theirs.speculation_snapshot()
    for key in ("hits", "misses", "presolved", "presolve_failed", "stale", "bank_size"):
        assert snap[key] == jsnap[key], key
    assert list(ours.spec_bank._entries) == list(theirs.spec_bank._entries)


def test_speculation_off_is_inert_and_hits_donate_warm_state(model):
    trace = sched.read_trace(BURST)[:6]
    plain = sched.Scheduler(make_synthetic_fleet(4, seed=11), model, mip_gap=GAP,
                            kv_bits="4bit", k_candidates=KS, device="cpu")
    sched.replay(plain, trace)
    assert plain.forecaster is None and plain.spec_bank is None
    assert not any(k.startswith("spec_") for k in plain.metrics.counters)
    spec = sched.Scheduler(make_synthetic_fleet(4, seed=11), model, mip_gap=GAP,
                           kv_bits="4bit", k_candidates=KS, device="cpu", speculative=True)
    hit_results = []
    for ev in trace:
        v = spec.handle(ev)
        if v.mode == "spec":
            hit_results.append((v.result, spec.pool.peek(v.key).last))
    assert hit_results and all(a is b for a, b in hit_results)
    blob = json.loads(json.dumps(spec.dump_state()))
    again = sched.Scheduler(make_synthetic_fleet(4, seed=11), model, mip_gap=GAP,
                            kv_bits="4bit", k_candidates=KS, device="cpu", speculative=True)
    again.load_state(blob)
    assert json.dumps(again.spec_bank.dump_state(), sort_keys=True) == json.dumps(
        spec.spec_bank.dump_state(), sort_keys=True)
