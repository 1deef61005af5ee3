"""The memory ledger of the port (``distilp_torch.obs.memory``) against the
JAX package's, on the CPU. Every comparison is exact.

- The ``/proc`` probes parse the same status and meminfo texts alike.
- The leak gate and headroom on injected samples: the same verdicts as
  the reference's ledger given the same baseline and newest sample
  (flat, grown, inside a tolerance, re-pinned across a structural
  boundary), and the same budget - RSS headroom.
- ``render_report`` of both packages renders the same dumps (the port's
  ledger with injected samples and static models, the reference's) to the
  same bytes; each dump round-trips byte-stably through either reader.
- On the CPU every device field is absent, never zero: samples, the
  timeline's ``mem.*`` series, an entry's first-dispatch model. The
  first-dispatch model on CUDA (peak delta, reserved delta, argument,
  output and temp bytes) is computed from the allocator's statistics, here
  a stand-in allocator; a loop plan's model is its owned bytes.
- The gateway degrades on low headroom only with a ledger's evidence, and
  ``GET /signals`` carries the ledger's headroom.
- ``serve --memory-out`` on the CPU and ``memory --load`` twice: identical
  reports, with ``ops/memmodel.py``'s analytic peak (the reference's
  formulas) printed beside them; ``--check`` refuses a dump with no
  allocated bytes to read.

~10 s in one process.
"""

import json
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from distilp_tpu.obs import memory as jmemory  # noqa: E402
from distilp_tpu.ops import memmodel as jmemmodel  # noqa: E402

from distilp_torch.cli import solver_cli  # noqa: E402
from distilp_torch.obs import compile_ledger as cl  # noqa: E402
from distilp_torch.obs import memory  # noqa: E402

STATUS = "Name:\tpython\nVmHWM:\t  204800 kB\nVmRSS:\t  102400 kB\nThreads:\t4\n"


def test_proc_probes_parse_like_the_reference(tmp_path):
    for text in (STATUS, "VmRSS: 77 kB\n", "VmRSS: lots kB\nVmHWM:\n", ""):
        assert memory.parse_proc_status(text) == jmemory.parse_proc_status(text)
    (tmp_path / "meminfo").write_text("MemFree: 1 kB\nMemTotal:  16384 kB\n")
    assert memory.read_meminfo_total(str(tmp_path / "meminfo")) == 16384 * 1024
    assert memory.read_meminfo_total(str(tmp_path / "none")) is None
    assert memory.read_proc_status(str(tmp_path / "none")) == {"rss_bytes": None,
                                                              "hwm_bytes": None}


def _injected(mod, base, last, budget):
    led = mod.MemoryLedger(budget_bytes=budget, sample_min_interval_s=3600.0)
    led._warm_sample = {"t": 0.0, "live_bytes": base, "rss_bytes": 10**6}
    led._last, led._last_t = {"t": 1.0, "live_bytes": last, "rss_bytes": 3 * 10**6}, 1e18
    return led


@pytest.mark.parametrize("base, last, tol", [
    (1000, 1000, 0), (1000, 1512, 0), (1000, 1512, 512), (1000, 900, 0), (None, 5, 0),
])
def test_leak_gate_and_headroom_on_injected_samples(base, last, tol):
    led, jled = _injected(memory, base, last, 10**9), _injected(jmemory, base, last, 10**9)
    assert led.leak_report(tol) == jled.leak_report(tol)
    if base is not None:
        assert led.leak_report(tol)["flat"] is (last - base <= tol)
    # headroom = budget - RSS of the fresh cached sample
    assert led.headroom_bytes(max_age_s=1e30) == jled.headroom_bytes(max_age_s=1e30) == (
        10**9 - 3 * 10**6)
    assert memory.MemoryLedger().headroom_bytes() is None  # no budget: absent


def test_structural_boundary_repins_the_baseline(monkeypatch):
    led = memory.MemoryLedger(sample_min_interval_s=0.0)
    reads = iter([{"allocated_bytes": a, "reserved_bytes": 2 * a, "max_allocated_bytes": a,
                   "by_device": {"cuda:0": a}} for a in (100, 700, 700, 900, 900)])
    monkeypatch.setattr(memory, "device_memory", lambda: next(reads))
    led.note_structural()  # before mark_warm: no-op
    assert led.leak_report() is None
    led.mark_warm()
    assert led.leak_report()["flat"] is True
    led.sample(force=True)  # 700 allocated: growth between boundaries is a leak
    assert led.leak_report()["growth_bytes"] == 600 and not led.leak_report()["flat"]
    led.note_structural()  # a new instance's buffers are provisioning
    assert led.leak_report()["flat"] is True
    led.sample(force=True)
    assert led.leak_report()["growth_bytes"] == 200
    s = led.summary()["watermarks"]
    assert s["peak_live_bytes"] == 900 and s["peak_reserved_bytes"] == 1800
    series = led.timeline_series()
    assert series["mem.live_bytes"] == 900.0 and series["mem.live_bytes.cuda:0"] == 900.0


def _port_dump():
    led = memory.MemoryLedger(budget_bytes=64 * 10**9)
    for i, live in enumerate((10**6, 3 * 10**6, 3 * 10**6)):
        rec = {"t": float(i), "live_bytes": live, "live_count": None,
               "reserved_bytes": 2 * live, "max_allocated_bytes": live,
               "rss_bytes": 5 * 10**8, "hwm_bytes": None, "by_platform": {"cuda:0": live}}
        led.samples.append(rec)
        led.sample_count += 1
        led._last = rec
        for k in led.peak:
            led._fold_peak(k, rec.get(k))
    led._warm_sample = dict(led.samples[1])
    model = {k: None for k in memory.MEM_ANALYSIS_FIELDS}
    model.update(peak_bytes=7 * 10**6, reserved_bytes=2 * 10**7, argument_bytes=10**6,
                 output_bytes=2 * 10**5, temp_bytes=6800000)
    led.analyses["solver.solve_sweep"] = {"memory": model, "flops": None,
                                          "bytes_accessed": None, "error": None}
    led.analyses["ops.ipm.ipm_solve_batch"] = {"memory": None, "flops": None,
                                               "bytes_accessed": None, "error": None}
    led.analyses["twin.twin_mc"] = {"memory": None, "flops": None, "bytes_accessed": None,
                                    "error": "TypeError: no device"}
    led.dispatches.update({"solver.solve_sweep": 12, "ops.ipm.ipm_solve_batch": 40,
                           "twin.twin_mc": 1})
    led.note_plan(4 * 10**6)
    return led.dump()


def _reference_dump():
    led = jmemory.MemoryLedger(budget_bytes=10**9)
    led.sample(force=True)
    led.mark_warm()
    led.analyses["solver._solve_packed"] = {
        "memory": {"temp_bytes": 123456, "argument_bytes": 789, "output_bytes": 10,
                   "alias_bytes": 0, "generated_code_bytes": 4096, "host_temp_bytes": None},
        "flops": 1.5e9, "bytes_accessed": 2e6, "error": None}
    led.dispatches["solver._solve_packed"] = 3
    return led.dump()


def test_render_report_is_the_same_bytes_in_both_packages():
    for dump in (_port_dump(), _reference_dump()):
        text = memory.memory_to_jsonl(dump)
        assert text == jmemory.memory_to_jsonl(dump)
        for reader in (memory.memory_from_jsonl, jmemory.memory_from_jsonl):
            assert memory.memory_to_jsonl(reader(text)) == text
        report = memory.render_report(dump)
        assert report == jmemory.render_report(dump)
        assert report == memory.render_report(memory.memory_from_jsonl(text))
    report = memory.render_report(_port_dump())
    assert "leak gate: FLAT" in report and "solver.device_loop.plan" in report
    assert "no static model (backend reported none): ops.ipm.ipm_solve_batch" in report


def test_cpu_fields_are_absent_and_first_dispatches_are_modelled(monkeypatch):
    # Distinct storages on the device, views counted once.
    a = torch.zeros(8)
    assert memory.device_bytes({"a": a, "b": [torch.zeros(2), a[2:]]},
                               torch.device("cpu")) == 40
    led = memory.enable(memory.MemoryLedger(budget_bytes=1 << 40, sample_min_interval_s=0.0))
    try:
        rec = led.sample(force=True)
        assert rec["live_bytes"] is None and rec["reserved_bytes"] is None
        series = led.timeline_series()
        assert not any(k.startswith("mem.live") for k in series)
        if rec["rss_bytes"] is not None:
            assert series["mem.headroom_bytes"] == (1 << 40) - series["mem.rss_bytes"]
        entry = cl.instrument("tests.mem.cpu", lambda x, device=None: x * 2)
        entry(torch.ones(4), device="cpu")
        entry(torch.ones(4), device="cpu")
        assert led.analyses["tests.mem.cpu"]["memory"] is None
        assert led.dispatches["tests.mem.cpu"] == 2
        # The first dispatch on CUDA, the card's allocator stood in for:
        # 1000 bytes allocated before, a peak of 5000 inside, 300 more
        # bytes reserved after; the result lies on the device.
        stats = SimpleNamespace(alloc=1000, peak=1000, reserved=8000, resets=0)

        def reset(dev):
            stats.resets += 1
            stats.peak = stats.alloc

        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda dev=None: stats.alloc)
        monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda dev=None: stats.peak)
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda dev=None: stats.reserved)
        monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
        monkeypatch.setattr(memory, "_device_storages",
                            lambda x, dev, out, depth=0: out.update(
                                {} if x is None or isinstance(x, dict) else
                                {id(x): 64} if isinstance(x, tuple) else {}))

        def solve(*args, device=None):
            stats.peak, stats.reserved = 5000, 8300
            return "out"

        gpu = cl.instrument("tests.mem.gpu", solve)
        gpu((1, 2), device="cuda")
        gpu((1, 2), device="cuda")  # modelled once
        m = led.analyses["tests.mem.gpu"]["memory"]
        assert stats.resets == 1 and led.dispatches["tests.mem.gpu"] == 2
        assert (m["peak_bytes"], m["reserved_bytes"], m["argument_bytes"]) == (4000, 300, 64)
        assert m["output_bytes"] == 0 and m["temp_bytes"] == 4000
        assert m["alias_bytes"] is None and m["generated_code_bytes"] is None
        assert led.peak["max_allocated_bytes"] == 5000
        # No analysis while a graph capture is open on the thread.
        with cl.capture_open():
            cl.instrument("tests.mem.captured", solve)((1,), device="cuda")
        assert "tests.mem.captured" not in led.analyses
        memory.note_plan(123456)
        memory.note_plan(999)
        plan = led.analyses[memory.PLAN_ENTRY]["memory"]
        assert plan["temp_bytes"] == plan["peak_bytes"] == 123456
        assert led.dispatches[memory.PLAN_ENTRY] == 2
    finally:
        memory.disable()
        for name in ("tests.mem.cpu", "tests.mem.gpu", "tests.mem.captured"):
            cl._REGISTRY.pop(name, None)


def test_gateway_degrades_on_evidence_and_signals_carry_headroom():
    from distilp_torch.gateway import Gateway
    from distilp_torch.obs import SignalsPayload, Timeline

    gw = Gateway(n_workers=1, scheduler_factory="tests.torch_procstub:make_scheduler",
                 mem_degrade_headroom_bytes=float(1 << 50), device="cpu")
    try:
        assert gw._admission and gw._mem_pressure() is False  # no ledger: no verdict
        led = memory.enable(memory.MemoryLedger(budget_bytes=1 << 40))
        try:
            if led.headroom_bytes() is None:
                pytest.skip("no readable RSS on this platform")
            assert gw._mem_pressure() is True
            assert gw.metrics.counters["mem_pressure"] == 1
            gw.mem_degrade_headroom_bytes = 1.0
            assert gw._mem_pressure() is False
            tl = Timeline()
            tl.record_many(1.0, {"queue_depth.w0": 0.0, **led.timeline_series()})
            gw.attach_slo(None, tl)
            sig = SignalsPayload.model_validate(gw.signals())
            assert 0 < sig.mem_headroom_bytes < float(1 << 40)
            assert "mem.rss_bytes" in gw.timeline_sample()
        finally:
            memory.disable()
    finally:
        gw.close()


def test_serve_memory_out_and_the_memory_report(tmp_path, capsys):
    out, metrics = tmp_path / "memory.jsonl", tmp_path / "m.json"
    argv = ["serve", "--trace", "tests/traces/scheduler_smoke_20.jsonl", "-p",
            "tests/profiles/llama_3_70b/online", "--synthetic-fleet", "4", "--fleet-seed",
            "11", "--k-candidates", "8,10", "--device", "cpu", "--quiet",
            "--memory-out", str(out), "--memory-budget-mb", "64000",
            "--metrics-out", str(metrics)]
    assert solver_cli.main(argv) == 0, capsys.readouterr().err[-2000:]
    assert memory.current() is None  # a serve-owned ledger is released
    m = json.loads(metrics.read_text())["memory"]
    assert m["budget_bytes"] == 64 * 10**9 and m["ledger_path"] == str(out)
    assert m["entries"]["solver.solve_sweep"]["memory"] is None  # the CPU: absent
    assert m["leak"] is None and m["watermarks"]["samples"] > 0
    reports = []
    for _ in range(2):
        capsys.readouterr()
        assert solver_cli.main(["memory", "--load", str(out), "--analytic-m", "4,16"]) == 0
        reports.append(capsys.readouterr().out)
    assert reports[0] == reports[1]
    dump = memory.memory_from_jsonl(out.read_text())
    assert reports[0].startswith(jmemory.render_report(dump))
    for M in (4, 16):
        for engine in ("ipm", "pdhg"):
            assert f"M={M:<5d} {engine:<5s} analytic={jmemmodel.peak_bytes(M, engine)} " in (
                reports[0])
    capsys.readouterr()
    assert solver_cli.main(["memory", "--load", str(out), "--check"]) == 1
    assert "no allocated bytes to read" in capsys.readouterr().err
    # A dump whose warm phase stayed flat passes the check.
    (tmp_path / "flat.jsonl").write_text(memory.memory_to_jsonl(_port_dump()))
    assert solver_cli.main(["memory", "--load", str(tmp_path / "flat.jsonl"), "--check"]) == 0
