"""The compile ledger of the port (``distilp_torch.obs.compile_ledger``)
against the JAX package's, on the CPU. Every comparison is exact.

- The same sequence of compile notes (first compiles, static flips, shape
  changes, exact recompiles, build-cache hits and misses, a storm) through
  both ledgers: the same causes, storm flags, counters and summary; each
  package's ``render_report`` renders both ledgers' dumps to the same
  bytes, and each dump round-trips byte-stably through either package's
  JSONL reader.
- The port's own events: a kernel library's build is ``cold`` (an nvcc
  run) or ``cache_hit``; a loop plan's capture is billed to the innermost
  instrumented entry point on the thread (``(unregistered)`` with none, the
  dispatching entry's on a search worker via ``attributed``) and
  classified by its plan signature (``per_k`` or an iteration budget:
  ``static_arg_flip``; sizes: ``shape_bucket_change``; the same signature
  again: ``recompile``); loading many libraries at once is no storm. No
  capture opens the memory ledger's samples.
- A scheduler tick that paid a capture (one noted on the solve path) says
  so: ``compiles`` counter, flight record and tick span.
- ``serve --compile-ledger-out`` on the CPU (the plans' builds standing in
  for captures, which only the card makes): the warm boundary is marked,
  the warm phase compiles nothing, and ``compiles --load --check`` renders
  identical bytes twice.

~15 s in one process.
"""

import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_tpu.obs import compile_ledger as jcl  # noqa: E402

from distilp_torch.cli import solver_cli  # noqa: E402
from distilp_torch.obs import compile_ledger as cl  # noqa: E402
from distilp_torch.obs import memory  # noqa: E402
from distilp_torch.solver import device_loop  # noqa: E402

NOTES = [
    # (entry, static, shapes, ms, cache)
    ("solver.solve_sweep", "per_k=False", "M=4", 120.0, None),
    ("solver.solve_sweep", "per_k=False", "M=5", 80.0, None),
    ("solver.solve_sweep", "per_k=True", "M=5", 90.0, None),
    ("solver.solve_sweep", "per_k=False", "M=4", 70.0, None),
    ("kernels.build", "library='ipm'", "abc", 9000.0, "miss"),
    ("kernels.build", "library='round'", "def", 3.0, "hit"),
    ("solver.solve_batch", "per_k=False", "L=8", 60.0, None),
] + [("ops.hot", "n=1", "s", 5.0, None)] * 6


def _fill(mod):
    led = mod.CompileLedger(storm_threshold=3, storm_window_s=600.0)
    for entry, static, shapes, ms, cache in NOTES:
        led.note_dispatch(entry)
        led.note_compile(entry, static, shapes, ms, cache=cache)
    return led


def _strip(ev):
    return {k: v for k, v in ev.items() if k not in ("t", "thread")}


def test_the_same_notes_give_the_same_causes_storms_and_counters():
    led, jled = _fill(cl), _fill(jcl)
    assert [_strip(e) for e in led.events] == [_strip(e) for e in jled.events]
    assert [e["cause"] for e in led.events][:7] == [
        "cold", "shape_bucket_change", "static_arg_flip", "recompile", "cold", "cache_hit",
        "cold"]
    assert led.counters() == jled.counters() and led.storms == jled.storms == 2
    assert led.cache_hit_rate() == jled.cache_hit_rate() == 0.5
    s, js = led.summary(), jled.summary()
    assert s["causes"] == js["causes"] and s["counters"] == js["counters"]
    for name in ("solver.solve_sweep", "kernels.build", "ops.hot"):
        assert {k: v for k, v in s["entries"][name].items() if k != "registered"} == {
            k: v for k, v in js["entries"][name].items() if k != "registered"}
    assert led.timeline_series() == jled.timeline_series()


@pytest.mark.parametrize("top", [5, 2])
def test_render_report_is_the_same_bytes_in_both_packages(top):
    for dump in (_fill(cl).dump(), _fill(jcl).dump()):
        text = cl.ledger_to_jsonl(dump)
        assert text == jcl.ledger_to_jsonl(dump)
        for reader in (cl.ledger_from_jsonl, jcl.ledger_from_jsonl):
            assert cl.ledger_to_jsonl(reader(text)) == text
        report = cl.render_report(dump, top=top)
        assert report == jcl.render_report(dump, top=top)
        assert report == cl.render_report(cl.ledger_from_jsonl(text), top=top)
        assert "storm-flagged events: 6" in report


def test_builds_and_captures_are_classified_and_attributed():
    led = cl.enable(cl.CompileLedger())
    try:
        cl.note_build("ipm", "0123abcd", 4100.0, nvcc_ran=True)
        cl.note_build("round", "4567ef01", 2.5, nvcc_ran=False)
        sig = device_loop.PlanSig(
            device="cuda:0", L=1, cap=64, B0=2, Bw=6, m=97, nf=209, M=16, n_k=2, per_k=False,
            ipm_iters=40, root_chunk=40, warm_iters=20, mip_gap=1e-3, max_rounds=50,
            has_warm=False, has_root_warm=False, a_lanes=False, nnz=900, nent=300,
            ncontrib=400, index_len=1500)
        entry = cl.instrument("tests.sweep", lambda s, phases: [
            cl.note_capture(*device_loop.ledger_signatures(p), 10.0) for p in phases])
        entry(sig, [sig, sig._replace(per_k=True), sig._replace(M=17, m=103),
                    sig._replace(warm_iters=30), sig])
        cl.note_capture(*device_loop.ledger_signatures(sig), 1.0)
        with cl.attributed(("tests.sweep",)):
            cl.note_capture(*device_loop.ledger_signatures(sig._replace(L=2)), 1.0)
        with cl.capture_open():
            assert cl.capturing()
            mled = memory.MemoryLedger()
            mled._last, mled._last_t = {"t": 0.0, "live_bytes": 5}, -1e9
            assert mled.sample(force=True)["fresh"] is False  # no sample in a capture
        assert not cl.capturing()
        events = list(led.events)
        assert [(e["entry"], e["cause"]) for e in events] == [
            ("kernels.build", "cold"), ("kernels.build", "cache_hit"),
            ("tests.sweep", "cold"), ("tests.sweep", "static_arg_flip"),
            ("tests.sweep", "shape_bucket_change"), ("tests.sweep", "static_arg_flip"),
            ("tests.sweep", "recompile"), (cl.UNREGISTERED, "cold"),
            ("tests.sweep", "shape_bucket_change")]
        assert events[0]["static"] == "library='ipm'" and events[0]["cache"] == "miss"
        assert "per_k=False" in events[2]["static"] and "M=16" in events[2]["shapes"]
        c = led.counters()
        assert c["dispatches"] == 1 and c["unattributed_compiles"] == 1
        assert c["compile_cache_hits"] == 1 and c["compile_cache_misses"] == 1
        assert "kernels.build" in cl.registered_entry_points()
        assert "solver.solve_sweep" in cl.registered_entry_points()
        # Six captures of one entry inside the window are a storm; a
        # process's libraries, loaded together, are none, however many.
        assert led.storms == 1 and events[6].get("storm_start")
        for i in range(2, 15):
            cl.note_build(f"lib{i}", f"{i:08x}", 1.0, nvcc_ran=False)
        assert led.storms == 1
        assert not any(e.get("storm") for e in led.events if e["entry"] == "kernels.build")
    finally:
        cl.disable()
        cl._REGISTRY.pop("tests.sweep", None)
    # With no ledger the notes and the wrappers cost a global read.
    cl.note_capture("a", "b", 1.0)
    assert cl.current() is None and len(led.events) == 22


@pytest.fixture(scope="module")
def online():
    from distilp_torch.common import load_model_profile
    from distilp_torch.utils import make_synthetic_fleet

    return (make_synthetic_fleet(4, seed=11),
            load_model_profile("tests/profiles/llama_3_70b/online/model_profile.json"))


def _capture_on_plan_build(monkeypatch):
    """On the CPU nothing is captured: note a capture wherever a plan is
    built (one per signature, as the card captures one)."""
    init = device_loop.LoopPlan.__init__

    def noting(self, sig):
        init(self, sig)
        cl.note_capture(*device_loop.ledger_signatures(sig), 1.0)

    device_loop.clear_plans()
    monkeypatch.setattr(device_loop.LoopPlan, "__init__", noting)


def test_a_tick_that_paid_a_capture_says_so(online, monkeypatch):
    from distilp_torch.obs import FlightRecorder
    from distilp_torch.sched import LoadTick, Scheduler

    _capture_on_plan_build(monkeypatch)
    devices, model = online
    flight = FlightRecorder(capacity=16)
    sched = Scheduler(devices, model, mip_gap=1e-3, k_candidates=[8, 10], flight=flight,
                      device="cpu")
    led = cl.enable(cl.CompileLedger())
    try:
        sched.handle(LoadTick(t_comm_jitter={}))
        sched.handle(LoadTick(t_comm_jitter={devices[0].name: 1.01}))
    finally:
        cl.disable()
        sched.close()
    recs = flight.snapshot("default")
    paid = [r for r in recs if "compile" in r]
    assert paid and paid[0]["compile"]["entries"] == ["solver.solve_sweep"]
    n = sum(r["compile"]["count"] for r in paid)
    assert sched.metrics.counters["compiles"] == n == len(led.events)


def test_serve_ledger_flags_and_compiles_report(online, monkeypatch, tmp_path, capsys):
    _capture_on_plan_build(monkeypatch)
    out, metrics = tmp_path / "ledger.jsonl", tmp_path / "m.json"
    # The smoke trace's drift events (a structural event re-shapes the
    # instance, and its new signature is a new plan by design).
    drift = [ln for ln in open("tests/traces/scheduler_smoke_20.jsonl")
             if json.loads(ln)["kind"] in ("load", "degrade")]
    (tmp_path / "drift.jsonl").write_text("".join(drift))
    argv = ["serve", "--trace", str(tmp_path / "drift.jsonl"), "-p",
            "tests/profiles/llama_3_70b/online", "--synthetic-fleet", "4", "--fleet-seed",
            "11", "--k-candidates", "8,10", "--device", "cpu", "--quiet",
            "--compile-ledger-out", str(out), "--compile-warm-events", "2",
            "--metrics-out", str(metrics)]
    assert solver_cli.main(argv) == 0, capsys.readouterr().err[-2000:]
    assert cl.current() is None  # a serve-owned ledger is released
    c = json.loads(metrics.read_text())["compile"]
    assert c["warm_boundary_marked"] and c["warm_phase_compiles"] == 0
    assert c["counters"]["compiles"] > 0 and c["unregistered_compiles"] == 0
    assert c["ledger_path"] == str(out) and "solver.solve_sweep" in c["registered"]
    reports = []
    for _ in range(2):
        capsys.readouterr()
        assert solver_cli.main(["compiles", "--load", str(out), "--check"]) == 0
        reports.append(capsys.readouterr().out)
    assert reports[0] == reports[1] and "compile-ledger check OK" in reports[0]
    assert reports[0].startswith(jcl.render_report(cl.ledger_from_jsonl(out.read_text())))
