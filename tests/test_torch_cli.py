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
- Every option and subcommand of a later slice exits 2 naming its ROADMAP
  item.
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
    (["--plot"], "A16"),
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
    ("serve", "A12"), ("overload", "A12"), ("autoscale", "A12"),
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
