"""The port's CLIs (``python -m distilp_torch.cli.{profiler_cli,solver_cli}``)
on the CPU (``--device cpu``, ``--backend cpu``), against the JAX package's.

- ``evaluate --json --backend cpu`` on the online fixture exits 0; its
  ``evaluation`` block equals the JAX CLI's, and the deterministic fields of
  its ``robustness`` block (base latency, sensitivity) agree within 1e-12
  (the twin engines sum in another order; the JAX package's solver modules,
  imported here, run its engine in float64).
- A solution saved by either CLI is accepted by the other's ``evaluate
  --solution``.
- ``--per-k`` and ``--expert-loads`` print the JAX CLI's k-curve and expert
  routing (objectives within 2x gap, the same placements), and refuse the
  same conflicting options.
- ``overload``, ``autoscale``, ``slo``, ``compiles`` and ``memory`` run to
  their contracts; ``--plot`` draws the reference's k-curve.
- ``serve --device cpu`` runs the chaos soak of the JAX package's
  ``make smoke-chaos`` to its contract and prints the reference's summary
  schema (the same replay, health and chaos blocks); ``spans`` converts its
  span JSONL into the Chrome JSON the JAX CLI writes, byte for byte; every
  SLO, ledger and gateway flag of ``serve`` is accepted and, like a
  fleet-tagged trace, routes ``serve`` through the gateway tier (its runs
  are ``tests/test_torch_gateway.py``'s), which refuses a fault plan over a
  fleet-tagged trace.
- ``--mesh-shards 4`` (the CLI declares its virtual mesh itself) certifies
  the online golden as the JAX CLI's ``smoke-shard`` does, and
  ``--mesh-shards 1`` prints the plain run's output byte for byte;
  ``--mesh-shards 2`` on the Mixtral profile prints the JAX CLI's k and
  objective.
Both CLIs run in this process (``main(argv)``), so no interpreter start or
JAX compile is paid twice.
"""

import importlib
import json

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

# The JAX package's solver turns on float64 when it loads; its twin engine
# computes in float64 only then.
importlib.import_module("distilp_tpu.solver.backend_jax")
from distilp_tpu.cli import solver_cli as jcli  # noqa: E402

from distilp_torch.cli import profiler_cli, solver_cli  # noqa: E402

ONLINE = "tests/profiles/llama_3_70b/online"
TOL = 1e-12


def _run(main, argv, capsys):
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _json_line(out):
    return json.loads(out.strip().splitlines()[-1])


def test_evaluate_matches_the_jax_cli(capsys):
    args = ["evaluate", "-p", ONLINE, "--backend", "cpu", "--json", "--samples", "256"]
    rc, out, err = _run(solver_cli.main, args + ["--device", "cpu",
                                                  "--check-determinism"], capsys)
    assert rc == 0, err
    ours = _json_line(out)
    rc, out, err = _run(jcli.main, args, capsys)
    assert rc == 0, err
    theirs = _json_line(out)
    assert ours["evaluation"] == theirs["evaluation"]
    a, b = ours["robustness"], theirs["robustness"]
    assert abs(a["base_latency_s"] - b["base_latency_s"]) <= TOL * abs(b["base_latency_s"])
    assert [s["name"] for s in a["sensitivity"]] == [s["name"] for s in b["sensitivity"]]
    for sa, sb in zip(a["sensitivity"], b["sensitivity"]):
        assert abs(sa["delta_s"] - sb["delta_s"]) <= TOL * abs(b["base_latency_s"])
    for key in ("samples", "seed", "sigma_compute", "sigma_comm", "sigma_disk",
                "sigma_mem", "dropout_p", "dropout_slowdown", "degrade"):
        assert a[key] == b[key]


def test_solutions_cross_packages(capsys, tmp_path):
    ours, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    rc, out, err = _run(solver_cli.main, ["-p", ONLINE, "--backend", "torch", "--device",
                                          "cpu", "--save-solution", str(ours)], capsys)
    assert rc == 0, err
    assert "Optimality: certified" in out
    rc, _, err = _run(jcli.main, ["-p", ONLINE, "--backend", "cpu", "--save-solution",
                                  str(theirs)], capsys)
    assert rc == 0, err
    saved = json.loads(ours.read_text())
    assert saved["k"] == 2 and saved["w"] == [13, 27]
    assert abs(saved["obj_value"] - json.loads(theirs.read_text())["obj_value"]) <= 2e-4 * 1.935
    evals = []
    for main, sol, extra in ((jcli.main, ours, []), (solver_cli.main, theirs,
                                                     ["--device", "cpu"])):
        rc, out, err = _run(main, ["evaluate", "-p", ONLINE, "--solution", str(sol),
                                   "--json", "--samples", "64", *extra], capsys)
        assert rc == 0, err
        evals.append(_json_line(out)["evaluation"])
    assert evals[0]["latency_s"] == pytest.approx(evals[1]["latency_s"], rel=2e-4)
    # The port's warm start reads either package's solution.
    rc, out, err = _run(solver_cli.main, ["-p", ONLINE, "--device", "cpu", "--warm-from",
                                          str(theirs)], capsys)
    assert rc == 0, err


@pytest.mark.parametrize("argv, item", [
    (["--mesh-shards", "2", "--lp-backend", "ipm", "--device", "cpu"],
     "requires the matrix-free pdhg engine"),
    (["--backend", "cpu", "--warm-from", "x.json"], "--backend torch"),
])
def test_deferred_options_exit_2(capsys, monkeypatch, argv, item):
    # The CLI declares a virtual mesh for --mesh-shards itself; keep it to
    # this test.
    monkeypatch.setenv("DISTILP_TORCH_VIRTUAL_DEVICES", "0")
    rc, _, err = _run(solver_cli.main, ["-p", ONLINE, *argv], capsys)
    assert rc == 2 and item in err


def _per_k_rows(out):
    return {int(r[0]): (float(r[1]), r[2], r[3]) for r in
            (ln.split() for ln in out.splitlines()) if r and r[0].isdigit()}


@pytest.mark.parametrize("backend, extra", [
    ("torch", ["--device", "cpu"]),
    ("cpu", ["--k-candidates", "20,40"]),
])
def test_per_k_matches_the_jax_cli(capsys, tmp_path, backend, extra):
    hermes = "tests/profiles/hermes_70b"
    gap = 1e-4
    sol = tmp_path / "sol.json"
    rc, out, err = _run(solver_cli.main, ["-p", hermes, "--backend", backend, "--mip-gap",
                                          str(gap), "--per-k", "--save-solution", str(sol),
                                          *extra], capsys)
    assert rc == 0, err
    ours = _per_k_rows(out)
    jextra = ["--k-candidates", "20,40"] if backend == "cpu" else []
    rc, out_j, err = _run(jcli.main, ["-p", hermes, "--backend",
                                      "jax" if backend == "torch" else "cpu", "--mip-gap",
                                      str(gap), "--per-k", *jextra], capsys)
    assert rc == 0, err
    theirs = _per_k_rows(out_j)
    assert sorted(ours) == sorted(theirs) and len(ours) == (9 if backend == "torch" else 2)
    for k, (obj, cert, assignment) in ours.items():
        assert cert == "True" and assignment == theirs[k][2]
        assert abs(obj - theirs[k][0]) <= 2 * gap * abs(theirs[k][0]) + 1e-6
    assert "Best: k=40" in out and json.loads(sol.read_text())["k"] == 40


def test_expert_loads_matches_the_jax_cli(capsys, tmp_path):
    mixtral = "tests/profiles/mixtral_8x7b"
    loads = tmp_path / "loads.json"
    loads.write_text(json.dumps([5.0, 3.0] + [1.0] * 6))
    sols = {}
    for name, main, extra in (("port", solver_cli.main, ["--device", "cpu"]),
                              ("jax", jcli.main, ["--backend", "jax"])):
        sols[name] = tmp_path / f"{name}.json"
        rc, out, err = _run(main, ["-p", mixtral, "--kv-bits", "8bit", "--mip-gap", "1e-3",
                                   "--expert-loads", str(loads), "--save-solution",
                                   str(sols[name]), *extra], capsys)
        assert rc == 0, err
        assert "Expert routing (load-weighted):" in out
        assert "Realized objective (at mapped expert loads):" in out
    ours, theirs = (json.loads(sols[n].read_text()) for n in ("port", "jax"))
    assert sorted(e for ids in ours["expert_of_device"] for e in ids) == list(range(8))
    assert sum(ours["expert_load_share"]) == pytest.approx(1.0)
    for key in ("k", "w", "n", "y", "expert_of_device"):
        assert ours[key] == theirs[key], key
    assert abs(ours["realized_objective"] - theirs["realized_objective"]) <= \
        2e-3 * abs(theirs["realized_objective"])
    # Inline values work too; bad ones and conflicting options exit 2.
    rc, _, err = _run(solver_cli.main, ["-p", mixtral, "--kv-bits", "8bit", "--mip-gap",
                                        "1e-3", "--backend", "cpu", "--expert-loads",
                                        "5,3,1,1,1,1,1,1"], capsys)
    assert rc == 0, err
    for argv in (["--expert-loads", "not,numbers"],
                 ["--expert-loads", "1,2", "--moe", "off"],
                 ["--expert-loads", "1,2", "--per-k"],
                 ["--expert-loads", "1,2", "--warm-from", str(sols["jax"])]):
        rc, _, err = _run(solver_cli.main, ["-p", mixtral, *argv], capsys)
        assert rc == 2 and "error" in err


@pytest.mark.parametrize("sub, item", [
    ("overload", "A12"), ("autoscale", "A12"), ("slo", "A12"), ("compiles", "A14"),
    ("memory", "A14"),
])
def test_deferred_subcommands_exit_2(capsys, tmp_path, sub, item):
    # The five subcommands of A12c and A14b are part of the port now: each
    # runs to its contract, cheaply (its full checks against the JAX
    # package are tests/test_torch_{traffic,slo,control,compile_ledger,
    # memory}.py's).
    assert not hasattr(solver_cli, "DEFERRED_SUBCOMMANDS")
    if sub == "overload":
        argv = ["overload", "--trace", "tests/traces/openloop_diurnal_burst.jsonl",
                "-p", ONLINE, "--workers", "1", "--time-scale", "0.001",
                "--max-queue-depth", "2", "--scheduler-factory",
                "tests.torch_procstub:make_scheduler", "--device", "cpu", "--check",
                "--expect-sheds", "--quiet"]
    elif sub == "autoscale":
        argv = ["autoscale", "--timeline", "tests/traces/slo_timeline_overload.jsonl",
                "--policy", "tests/traces/control_policy.json", "--spec",
                "tests/traces/slo_overload_spec.json", "--step-s", "0.5", "--expect",
                "tests/traces/control_expected_actions.jsonl", "--check", "--quiet"]
    elif sub == "slo":
        argv = ["slo", "--spec", "tests/traces/slo_overload_spec.json", "--timeline",
                "tests/traces/slo_timeline_overload.jsonl", "--step-s", "0.1", "--expect",
                "tests/traces/slo_expected_alerts.json", "--check", "--quiet"]
    elif sub == "compiles":
        from distilp_torch.obs import compile_ledger

        led = compile_ledger.CompileLedger()
        led.note_compile("solver.solve_sweep", "per_k=False", "M=3", 12.5)
        led.dump_jsonl(tmp_path / "ledger.jsonl")
        argv = ["compiles", "--load", str(tmp_path / "ledger.jsonl"), "--check"]
    else:
        from distilp_torch.obs import memory

        mled = memory.MemoryLedger(budget_bytes=10**9)
        mled.samples.append({"t": 0.0, "live_bytes": 100, "rss_bytes": 10**6})
        mled._last, mled._warm_sample = dict(mled.samples[-1]), dict(mled.samples[-1])
        mled.dump_jsonl(tmp_path / "memory.jsonl")
        argv = ["memory", "--load", str(tmp_path / "memory.jsonl"), "--check"]
    rc, out, err = _run(solver_cli.main, argv, capsys)
    assert rc == 0, err[-2000:]
    assert "ROADMAP" not in err and item not in err


def test_evaluate_refuses_bad_input(capsys, tmp_path):
    rc, _, err = _run(solver_cli.main, ["evaluate", "-p", ONLINE, "--samples", "0"], capsys)
    assert rc == 2 and "samples" in err
    rc, _, err = _run(solver_cli.main, ["evaluate", "-p", str(tmp_path / "none")], capsys)
    assert rc == 2
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"k": 1, "w": [80, 0], "n": [0, 0], "obj_value": 1.0,
                               "sets": {}}))
    rc, _, err = _run(solver_cli.main, ["evaluate", "-p", ONLINE, "--solution", str(bad),
                                        "--device", "cpu"], capsys)
    assert rc == 2 and "cannot execute" in err


def test_default_device_needs_a_gpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _, err = _run(solver_cli.main, ["evaluate", "-p", ONLINE], capsys)
    assert rc == 2 and "CUDA device" in err


def test_profiler_cli_on_the_cpu(capsys, tmp_path, monkeypatch):
    for k, v in {"DPERF_MEM_MB": "4", "DPERF_DISK_FILE_MB": "2", "DPERF_GEMM_ITERS": "2",
                 "DPERF_GEMM_WARMUP": "0"}.items():
        monkeypatch.setenv(k, v)
    out, raw = tmp_path / "dev.json", tmp_path / "raw.json"
    rc, _, err = _run(profiler_cli.main, [
        "device", "-r", "tests/configs/phi3_mini.json", "--device", "cpu", "--not-head",
        "--max-batch-exp", "1", "-o", str(out), "--raw-out", str(raw)], capsys)
    assert rc == 0, err
    prof, di = json.loads(out.read_text()), json.loads(raw.read_text())
    assert prof["is_head"] is False and prof["T_cpu"] > 0
    assert di["interconnect"]["provenance"] == "unmeasured"
    rc, _, err = _run(profiler_cli.main, ["model", "-r", "tests/configs/phi3_mini.json",
                                          "--raw-out", str(raw)], capsys)
    assert rc == 2 and "--raw-out" in err
    model_out = tmp_path / "model.json"
    rc, _, err = _run(profiler_cli.main, ["model", "-r", "tests/configs/phi3_mini.json",
                                          "-o", str(model_out), "--batches", "1,2"], capsys)
    assert rc == 0 and json.loads(model_out.read_text())


def test_mesh_shards_on_a_virtual_mesh(capsys, monkeypatch):
    """The reference's ``smoke-shard``: plain, one shard and four shards on
    the online fixture with the PDHG engine."""
    monkeypatch.setenv("DISTILP_TORCH_VIRTUAL_DEVICES", "0")
    base = ["-p", ONLINE, "--device", "cpu", "--lp-backend", "pdhg"]
    rc, plain, err = _run(solver_cli.main, base, capsys)
    assert rc == 0, err
    rc, one, err = _run(solver_cli.main, base + ["--mesh-shards", "1"], capsys)
    assert rc == 0, err
    assert one == plain
    rc, four, err = _run(solver_cli.main, base + ["--mesh-shards", "4"], capsys)
    assert rc == 0, err
    assert "Optimal k: 2" in four and "Objective value: 1.934942" in four
    assert "Optimality: certified" in four


def test_mesh_shards_on_a_moe_profile(capsys, monkeypatch):
    """MoE nodes on the row mesh (K6b's per-element route): the JAX CLI's
    ``-p tests/profiles/mixtral_8x7b --kv-bits 8bit --lp-backend pdhg
    --mesh-shards 2`` prints k 4 and objective -82.677178, certified."""
    monkeypatch.setenv("DISTILP_TORCH_VIRTUAL_DEVICES", "0")
    # One intra-op thread: the plain per-element products are small, and a
    # parallel region each costs far more with several test processes.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        rc, out, err = _run(solver_cli.main, [
            "-p", "tests/profiles/mixtral_8x7b", "--device", "cpu", "--kv-bits", "8bit",
            "--lp-backend", "pdhg", "--mesh-shards", "2"], capsys)
    finally:
        torch.set_num_threads(threads)
    assert rc == 0, err
    assert "Optimal k: 4" in out and "Objective value: -82.677178" in out
    assert "Optimality: certified" in out and "Expert placement" in out


def test_plot_draws_the_jax_cli_curve(capsys, monkeypatch):
    from distilp_tpu.solver import plotter as jplotter

    from distilp_torch.solver import plotter

    drawn = {"port": [], "jax": []}
    monkeypatch.setattr(plotter, "plot_k_curve",
                        lambda objs, k_star=None, **kw: drawn["port"].append((objs, k_star)))
    monkeypatch.setattr(jplotter, "plot_k_curve",
                        lambda objs, k_star=None, **kw: drawn["jax"].append((objs, k_star)))
    for main, extra in ((solver_cli.main, ["--device", "cpu"]), (jcli.main, [])):
        rc, _, err = _run(main, ["-p", ONLINE, "--backend", "cpu", "--plot", *extra], capsys)
        assert rc == 0, err
    (ours, k), (theirs, jk) = drawn["port"][0], drawn["jax"][0]
    assert k == jk == 2 and [x for x, _ in ours] == [x for x, _ in theirs]
    for (_, a), (_, b) in zip(ours, theirs):
        assert (a is None) == (b is None) and (a is None or abs(a - b) <= 2e-4 * abs(b))


CHAOS = ["serve", "--trace", "tests/traces/scheduler_smoke_20.jsonl", "--profile", ONLINE,
         "--synthetic-fleet", "4", "--fleet-seed", "11", "--k-candidates", "8,10",
         "--fault-plan", "tests/traces/chaos_plan.json", "--deadline-ms", "60000",
         "--max-retries", "2", "--breaker-threshold", "2", "--chaos-check", "--quiet"]


def _schema(obj):
    """Key structure of a summary (the metrics' counter names aside)."""
    if isinstance(obj, dict):
        return {k: (None if k == "counters" else _schema(v)) for k, v in obj.items()}
    return type(obj).__name__


def test_serve_chaos_soak_matches_the_jax_cli(capsys, tmp_path):
    """The acceptance command of ``serve`` on the CPU, beside the JAX
    CLI's: both pass the soak contract with the same injected faults and
    quarantines and print summaries of one schema; the port's spans, flight
    dump directory and timeline ride along."""
    rc, out, err = _run(solver_cli.main, CHAOS + [
        "--device", "cpu", "--trace-spans-dir", str(tmp_path / "spans"),
        "--flight-dir", str(tmp_path / "flight"), "--timeline-dir", str(tmp_path / "tl"),
        "--timeline-period-ms", "5", "--metrics-out", str(tmp_path / "port.json")], capsys)
    assert rc == 0, err
    assert "chaos soak OK: 9 fault(s) injected, 4 quarantined" in out
    ours = json.loads((tmp_path / "port.json").read_text())
    rc, out_j, err = _run(jcli.main, CHAOS + ["--metrics-out", str(tmp_path / "jax.json")],
                          capsys)
    assert rc == 0, err
    assert "chaos soak OK: 9 fault(s) injected, 4 quarantined" in out_j
    theirs = json.loads((tmp_path / "jax.json").read_text())
    for key in ("obs", "slo"):
        assert key in ours
        ours.pop(key)
    assert _schema(ours) == _schema(theirs)
    assert ours["chaos"] == theirs["chaos"]
    assert ours["health"]["state"] == theirs["health"]["state"] == "healthy"
    assert ours["replay"]["events"] == theirs["replay"]["events"] == 20
    assert ours["replay"]["structural_uncertified"] == 0
    for name in ("events_quarantined", "breaker_open", "breaker_close",
                 "breaker_short_circuit", "solve_retries", "tick_failed"):
        assert ours["metrics"]["counters"].get(name) == theirs["metrics"]["counters"].get(name)
    assert (tmp_path / "tl" / "timeline.jsonl").is_file()
    assert list((tmp_path / "flight").glob("postmortem-default-*.jsonl"))
    # spans: the port's Chrome JSON and stats equal the JAX CLI's.
    spans = tmp_path / "spans" / "spans.jsonl"
    for main, name in ((solver_cli.main, "port"), (jcli.main, "jax")):
        rc, _, err = _run(main, ["spans", str(spans), "--out", str(tmp_path / f"{name}.chrome"),
                                 "--quiet"], capsys)
        assert rc == 0, err
    assert (tmp_path / "port.chrome").read_bytes() == (tmp_path / "jax.chrome").read_bytes()
    stats = [_run(main, ["spans", str(tmp_path / "spans"), "--stats"], capsys)[1]
             for main in (solver_cli.main, jcli.main)]
    assert stats[0] == stats[1] and "sched.tick" in stats[0]
    rc, _, err = _run(solver_cli.main, ["spans", str(tmp_path / "none")], capsys)
    assert rc == 2 and "no span JSONL" in err


def test_serve_plain_summary_and_errors(capsys, tmp_path):
    trace = tmp_path / "t.jsonl"
    trace.write_text("".join(open("tests/traces/scheduler_smoke_20.jsonl").readlines()[:3]))
    args = ["serve", "--trace", str(trace), "-p", ONLINE, "--synthetic-fleet", "4",
            "--fleet-seed", "11", "--k-candidates", "8,10", "--device", "cpu"]
    rc, out, err = _run(solver_cli.main, args + ["--speculate", "--risk-aware"], capsys)
    assert rc == 0, err
    summary = _json_line(out)
    assert set(summary) == {"replay", "drift_warm_share", "metrics", "speculation", "risk"}
    assert summary["risk"]["evals"] == 3 and summary["speculation"]["enabled"] is True
    assert len([ln for ln in out.splitlines() if ln.startswith("[")]) == 3
    rc, _, err = _run(solver_cli.main, args + ["--chaos-check"], capsys)
    assert rc == 2 and "--fault-plan" in err
    (tmp_path / "empty.jsonl").write_text("")
    rc, _, err = _run(solver_cli.main, [*args[:2], str(tmp_path / "empty.jsonl"), *args[3:]],
                      capsys)
    assert rc == 2 and "empty" in err


@pytest.mark.parametrize("flags, item", [
    (["--workers", "2"], "A12b"), (["--worker-backend", "process"], "A12b"),
    (["--scheduler-factory", "m:f"], "A12b"), (["--supervise"], "A12b"),
    (["--recovery-dir", "d"], "A12b"), (["--snapshot-every", "4"], "A12b"),
    (["--listen", "127.0.0.1:0"], "A12b"), (["--max-queue-depth", "4"], "A12b"),
    (["--coalesce"], "A12b"), (["--degrade-depth", "2"], "A12b"),
    (["--snapshot-dir", "d"], "A12b"), (["--snapshot-at", "3"], "A12b"),
    (["--halt-after-snapshot"], "A12b"), (["--resume"], "A12b"),
    (["--slo", "s.json"], "A12c"), (["--capacity-eps", "50"], "A12c"),
    (["--compile-ledger"], "A14b"), (["--compile-ledger-out", "c.jsonl"], "A14b"),
    (["--compile-warm-events", "3"], "A14b"), (["--memory-ledger"], "A14b"),
    (["--memory-out", "m.jsonl"], "A14b"), (["--memory-budget-mb", "100"], "A14b"),
    (["--mem-degrade-headroom-mb", "10"], "A14b"),
], ids=lambda v: v[0] if isinstance(v, list) else v)
def test_serve_later_slice_flags_exit_2(capsys, monkeypatch, flags, item):
    # The gateway tier (A12b), the SLO layer (A12c) and the compile and
    # memory ledgers (A14b) are part of the port now: each flag is
    # accepted, and with --workers 2 serve goes through the gateway path
    # with it set (the flags' runs are tests/test_torch_gateway.py's and
    # the ledger, SLO and traffic files').
    argv = ["serve", "--trace", "tests/traces/scheduler_smoke_20.jsonl", "-p", ONLINE,
            "--device", "cpu", *flags]
    if flags[0] == "--mem-degrade-headroom-mb":
        argv.append("--memory-ledger")  # headroom comes from the memory ledger
    seen = []
    monkeypatch.setattr(solver_cli, "_serve_gateway", lambda a: seen.append(a) or 0)
    rc, _, err = _run(solver_cli.main, [*argv, "--workers", "2"], capsys)
    assert rc == 0 and "ROADMAP" not in err and len(seen) == 1, err
    name = flags[0][2:].replace("-", "_")
    want = True if len(flags) == 1 else type(getattr(seen[0], name))(flags[1])
    assert getattr(seen[0], name) == want


def test_serve_refuses_a_fleet_tagged_trace(capsys, monkeypatch):
    argv = ["serve", "--trace", "tests/traces/gateway_smoke_10f.jsonl", "-p", ONLINE,
            "--device", "cpu"]
    # A fleet-tagged trace is served by the gateway tier ...
    seen = []
    monkeypatch.setattr(solver_cli, "_serve_gateway", lambda a: seen.append(a) or 0)
    rc, _, err = _run(solver_cli.main, argv, capsys)
    assert rc == 0 and len(seen) == 1 and seen[0].workers == 1
    monkeypatch.undo()
    # ... which refuses a fault plan over it (the plan's ticks are one
    # fleet's).
    rc, _, err = _run(solver_cli.main, [*argv, "--fault-plan", "tests/traces/chaos_plan.json"],
                      capsys)
    assert rc == 2 and "single-fleet trace" in err


def test_serve_default_device_needs_a_gpu(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _, err = _run(solver_cli.main, CHAOS[:9] + ["--k-candidates", "8,10", "--quiet"],
                      capsys)
    assert rc == 1 and "CUDA device" in err
