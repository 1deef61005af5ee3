"""The port's CLIs (``python -m distilp_torch.cli.{profiler_cli,solver_cli}``)
on the CPU (``--device cpu``, ``--backend cpu``), against the JAX package's.

- ``evaluate --json --backend cpu`` on the online fixture exits 0; its
  ``evaluation`` block equals the JAX CLI's, and the deterministic fields of
  its ``robustness`` block (base latency, sensitivity) agree within 1e-12
  (the twin engines sum in another order; the JAX package's solver modules,
  imported here, run its engine in float64).
- A solution saved by either CLI is accepted by the other's ``evaluate
  --solution``.
- Every option and subcommand of a later slice exits 2 naming its ROADMAP
  item.
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
    (["--per-k"], "A8"),
    (["--expert-loads", "1,2"], "A8"),
    (["--mesh-shards", "2"], "A13"),
    (["--plot"], "A16"),
    (["--backend", "cpu", "--warm-from", "x.json"], "--backend torch"),
])
def test_deferred_options_exit_2(capsys, argv, item):
    rc, _, err = _run(solver_cli.main, ["-p", ONLINE, *argv], capsys)
    assert rc == 2 and item in err


@pytest.mark.parametrize("sub, item", [
    ("serve", "A12"), ("overload", "A12"), ("autoscale", "A12"), ("diagnose", "A9"),
    ("spans", "A14"), ("slo", "A14"), ("compiles", "A14"), ("memory", "A14"),
])
def test_deferred_subcommands_exit_2(capsys, sub, item):
    rc, _, err = _run(solver_cli.main, [sub, "-p", ONLINE], capsys)
    assert rc == 2 and item in err and "ROADMAP" in err


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
