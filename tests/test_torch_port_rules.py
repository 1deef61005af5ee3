"""Rules of the PyTorch/CUDA port, checked on its source.

- No module of ``distilp_torch`` (its model profiler included), not
  ``chip_smoke.py`` and not the test helpers it imports
  (``tests/torch_price_edits.py``, ``tests/torch_lanes.py``) imports JAX or anything of the JAX package
  (``distilp_tpu``), jax-free modules included: the port keeps its own
  copies.
- ``triton``/kernel builds never happen at import time: importing every
  module of the port works on a host without nvcc or a GPU.
- Every kernel source named by the build exists, and each kernel wrapper
  counts its launches under the name ``chip_smoke.py`` reads.
- The sweep variants (per-k, load-aware routing, the async solve and its
  worker thread) run without JAX in the process, and their entry points
  raise without a GPU unless the caller asks for the CPU.
- So do the streaming replanner, the scenario sweep and the batch layout.
- The convergence report layer (``distilp_torch/obs``) is the port's own
  copy and is checked like every other module.
- So are the mesh, its collectives and the node-sharded sweep
  (``distilp_torch/parallel``), with their kernel sources.
- So are the packed halves and the device loop (``solver/packed.py``,
  ``solver/device_loop.py``) with the loop's kernel source, which fails its
  build on a toolkit without conditional WHILE graph nodes.
- So are the scheduler daemon (``distilp_torch/sched``), the tracing base
  (``obs/{trace,flight,export,timeline}.py``, ``utils/lockwatch.py``; these
  import neither torch nor numpy), the fleet-tagged trace reader
  (``gateway/traces.py``) and the k-curve plotter; a chaos ``serve`` and a
  ``spans`` conversion run in a process that never loads JAX.
- So are the gateway tier (``distilp_torch/gateway``), the cross-shard
  combiner (``distilp_torch/combine``), the memory model
  (``ops/memmodel.py``) and the process workers' test stub
  (``tests/torch_procstub.py``); the gateway, the combiner and the load
  generator raise without a GPU unless the caller asks for the CPU, and a
  ``serve --workers 2`` runs in a process that never loads JAX.
- So are open-loop traffic (``distilp_torch/traffic``), the autoscaler
  (``distilp_torch/control``), the SLO engine and the compile and memory
  ledgers (``obs/{slo,compile_ledger,memory}.py``, stdlib at import); an
  ``overload``, an ``slo`` and an ``autoscale`` run in a process that never
  loads JAX.
"""

import ast
import importlib
import pkgutil
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "distilp_tpu")


def _port_files():
    files = sorted((REPO / "distilp_torch").rglob("*.py"))
    assert files, "distilp_torch has no modules"
    # chip_smoke.py, chip_gemm_turns.py and the test helpers they import.
    return files + [REPO / "chip_smoke.py", REPO / "chip_gemm_turns.py",
                    REPO / "tests" / "torch_price_edits.py",
                    REPO / "tests" / "torch_lanes.py", REPO / "tests" / "torch_procstub.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.lineno, str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_never_imports_jax_or_the_jax_package(path):
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_the_profiler_copy_is_checked_and_stays_offline(tmp_path):
    """The port's model profiler is one of the checked modules, and its
    config loader refuses anything but a local file (no network)."""
    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for name in ("__init__", "analytic", "api", "hfconfig", "datatypes", "device",
                 "topology"):
        assert f"distilp_torch/profiler/{name}.py" in files
    from distilp_torch.profiler import load_config, load_config_from_repo

    with pytest.raises(RuntimeError, match="local config path"):
        load_config("mistralai/Mixtral-8x7B-v0.1")
    with pytest.raises(RuntimeError, match="local config path"):
        load_config_from_repo(str(tmp_path / "missing"))
    cfg = load_config(REPO / "tests" / "configs" / "mixtral_8x7b.json")
    assert cfg.raw["model_type"] == "mixtral"


def test_the_convergence_copy_is_checked():
    """The port's own copy of the convergence report layer is one of the
    checked modules, and it loads with neither torch nor numpy imported by
    it (plain lists in, pydantic reports out)."""
    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for name in ("__init__", "convergence"):
        assert f"distilp_torch/obs/{name}.py" in files
    roots = {mod for _, mod in _imported_roots(REPO / "distilp_torch" / "obs" / "convergence.py")}
    assert not roots & {"torch", "numpy", *FORBIDDEN}


def test_every_port_module_imports_without_a_gpu():
    import distilp_torch

    names = [m.name for m in pkgutil.walk_packages(distilp_torch.__path__, "distilp_torch.")]
    assert "distilp_torch.solver.backend_torch" in names
    assert "distilp_torch.profiler.analytic" in names
    for name in ("distilp_torch.twin.engine", "distilp_torch.profiler.device",
                 "distilp_torch.cli.solver_cli", "distilp_torch.cli.profiler_cli",
                 "distilp_torch.obs.convergence"):
        assert name in names
    for name in names:
        importlib.import_module(name)


def test_kernel_sources_and_launch_counters():
    from distilp_torch import kernels
    from distilp_torch.kernels import build

    for src, _ in build.SOURCES.values():
        assert (build.CSRC / src).is_file(), src
    for h in build.HEADERS:
        assert (build.CSRC / h).is_file(), h
    assert set(kernels.LAUNCHES) == {
        "ipm", "round_incumbent", "round_moe", "bnb_epilogue", "pdhg", "decomp",
        "twin_mc", "hbm_stream", "gemm_absmax_scale", "bnb_per_k", "price_fixed",
        "round_incumbent_lanes", "round_moe_lanes", "bnb_epilogue_lanes", "bnb_per_k_lanes",
        "decomp_lanes", "pdhg_elem", "ipm_trace", "pdhg_trace", "pdhg_sharded",
        "pdhg_sharded_elem", "collective", "round_tail", "round_tail_lanes", "bnb_graph",
        "bnb_seed", "bnb_head", "bnb_control", "bnb_answer", "decomp_theta", "decomp_bound",
        "bnb_cast", "bnb_gather",
    }
    kernels.LAUNCHES["ipm"] = 3
    kernels.reset_launch_counts()
    assert set(kernels.LAUNCHES.values()) == {0}


def test_cpu_tensors_take_the_plain_versions_and_count_nothing(profiles_dir):
    from distilp_torch import kernels
    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.solver import halda_solve

    kernels.reset_launch_counts()
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    halda_solve(devs, model, mip_gap=1e-4, kv_bits="4bit", device="cpu")
    assert set(kernels.LAUNCHES.values()) == {0}


def test_mixed_devices_are_refused():
    from distilp_torch import kernels

    with pytest.raises(ValueError, match="mixed"):
        kernels.on_cuda(torch.zeros(1), torch.zeros(1, device="meta"))
    assert kernels.on_cuda(torch.zeros(1), None) is False


def test_sweep_variants_are_checked_modules_and_run_without_jax(tmp_path):
    """The routing module and the async worker are among the checked files,
    and a per-k solve, a load-aware routing loop and an async solve (its
    worker thread included) run in a process that never loads JAX."""
    import subprocess
    import sys

    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for name in ("routing", "backend_torch", "api", "search", "rounding"):
        assert f"distilp_torch/solver/{name}.py" in files
    script = (
        "import sys\n"
        "from distilp_torch.common import load_from_profile_folder\n"
        "from distilp_torch.solver import (halda_solve_async, halda_solve_per_k,\n"
        "    solve_load_aware)\n"
        "p = 'tests/profiles/'\n"
        "devs, model = load_from_profile_folder(p + 'llama_3_70b/online')\n"
        "r = halda_solve_async(devs, model, kv_bits='4bit', device='cpu').collect()\n"
        "assert r.certified and r.k == 2, r\n"
        "assert len(halda_solve_per_k(devs, model, kv_bits='4bit', device='cpu')) >= 2\n"
        "devs, model = load_from_profile_folder(p + 'mixtral_8x7b')\n"
        "res, mapping, realized = solve_load_aware(devs, model, expert_loads=[5, 3] + [1] * 6,\n"
        "    mip_gap=1e-3, device='cpu')\n"
        "assert realized is not None\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "    'distilp_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                       "PYTHONPATH": str(REPO),
                                                       "HOME": str(tmp_path)})
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


def test_streaming_and_batch_layout_are_checked_modules_and_run_without_jax(tmp_path):
    """The replanner and the batch layout are among the checked files, and a
    replanner tick, a scenario sweep and a lane batch run in a process that
    never loads JAX."""
    import subprocess
    import sys

    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for name in ("streaming", "batchlayout"):
        assert f"distilp_torch/solver/{name}.py" in files
    script = (
        "import sys\n"
        "from distilp_torch.common import load_from_profile_folder\n"
        "from distilp_torch.solver import (StreamingReplanner, halda_solve_scenarios,\n"
        "    pack_instance, solve_batch)\n"
        "from distilp_torch.solver.api import _build_instance\n"
        "devs, model = load_from_profile_folder('tests/profiles/llama_3_70b/online')\n"
        "p = StreamingReplanner(kv_bits='4bit', device='cpu')\n"
        "assert p.step(devs, model).k == 2 and p.step(devs, model).certified\n"
        "rs = halda_solve_scenarios([devs, devs], model, kv_bits='4bit', device='cpu')\n"
        "assert [r.k for r in rs] == [2, 2]\n"
        "Ks, _, c, a = _build_instance(devs, model, None, '4bit', None, None)\n"
        "inst = pack_instance(a, [(k, model.L // k) for k in Ks], coeffs=c, M_pad=4)\n"
        "assert solve_batch([inst], device='cpu')[0][1].k == 2\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "    'distilp_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                       "PYTHONPATH": str(REPO),
                                                       "HOME": str(tmp_path)})
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


def test_sweep_variant_entry_points_need_a_gpu_by_default(profiles_dir, monkeypatch):
    from distilp_torch.common import load_from_profile_folder
    from distilp_torch.solver import (
        halda_solve_async,
        halda_solve_per_k,
        map_experts,
        normalize_loads,
        realized_objective,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    devs, model = load_from_profile_folder(profiles_dir / "llama_3_70b" / "online")
    for fn in (halda_solve_per_k, halda_solve_async):
        with pytest.raises(RuntimeError, match="CUDA device"):
            fn(devs, model, kv_bits="4bit", device=None)
    from distilp_torch.solver import StreamingReplanner, halda_solve_scenarios, solve_batch
    from distilp_torch.solver.api import _build_instance
    from distilp_torch.solver.batchlayout import pack_instance

    with pytest.raises(RuntimeError, match="CUDA device"):
        halda_solve_scenarios([devs, devs], model, kv_bits="4bit")
    planner = StreamingReplanner(kv_bits="4bit")
    for tick in (planner.step, planner.submit):
        with pytest.raises(RuntimeError, match="CUDA device"):
            tick(devs, model)
    Ks, _, coeffs, arrays = _build_instance(devs, model, None, "4bit", None, None)
    inst = pack_instance(arrays, [(k, model.L // k) for k in Ks], coeffs=coeffs)
    with pytest.raises(RuntimeError, match="CUDA device"):
        solve_batch([inst])
    devs, model = load_from_profile_folder(profiles_dir / "mixtral_8x7b")
    result = type("R", (), {"k": 4, "w": [5, 5, 5, 5], "n": [0] * 4, "y": [2, 2, 2, 2]})
    mapping = map_experts(result.y, [1.0] * 4, normalize_loads(None, 8))
    with pytest.raises(RuntimeError, match="CUDA device"):
        realized_objective(devs, model, result, mapping, device=None)


def test_the_mesh_modules_and_kernels_are_checked_and_run_without_jax(tmp_path):
    """``distilp_torch/parallel`` is among the checked files, the row-sharded
    PDHG (K6b) and the collectives have their own sources beside K5's
    (whose source and flags stay as they were), each wrapper counts under
    the name ``chip_smoke.py`` reads (K6b's per-element entry under its
    own), and a sharded solve on a virtual CPU mesh runs in a process that
    never loads JAX."""
    import subprocess
    import sys

    from distilp_torch.kernels import build

    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for name in ("__init__", "devices", "collectives", "mesh"):
        assert f"distilp_torch/parallel/{name}.py" in files
    assert build.SOURCES["pdhg_sharded"] == ("pdhg_sharded_kernel.cu", ["--fmad=false"])
    assert build.SOURCES["collective"] == ("collective_kernel.cu", [])
    assert build.SOURCES["pdhg"] == ("pdhg_kernel.cu", [])
    for src in ("pdhg_sharded_kernel.cu", "collective_kernel.cu"):
        text = (build.CSRC / src).read_text()
        assert "Replaces" in text and "distilp_tpu/" in text and "What bounds it on an H100" in text
    meshlp = (REPO / "distilp_torch" / "ops" / "meshlp.py").read_text()
    assert 'count_launch("pdhg_sharded"' in meshlp
    assert 'count_launch("pdhg_sharded_elem"' in meshlp
    # K6b's fused route: its entry points in the kernel source, the library's
    # signatures and the wrapper (both entries, both dtypes)
    sharded = (build.CSRC / "pdhg_sharded_kernel.cu").read_text()
    assert "pdhgs_fused_kernel" in sharded
    for fn in ("dtk_pdhgs_fused_f32", "dtk_pdhgs_fused_f64", "dtk_pdhgs_elem_fused_f32",
               "dtk_pdhgs_elem_fused_f64", "dtk_pdhgs_fused_grid",
               "dtk_pdhgs_fused_max_shards"):
        assert f"int {fn}(" in sharded or f"size_t {fn}(" in sharded, fn
        assert fn in build.SIGNATURES["pdhg_sharded"] and f"lib.{fn}" in meshlp, fn
    assert 'count_launch("collective")' in (REPO / "distilp_torch" / "parallel" /
                                             "collectives.py").read_text()
    script = (
        "import os, sys\n"
        "os.environ['DISTILP_TORCH_VIRTUAL_DEVICES'] = '2'\n"
        "from distilp_torch.common import load_from_profile_folder\n"
        "from distilp_torch.solver import halda_solve\n"
        "devs, model = load_from_profile_folder('tests/profiles/llama_3_70b/online')\n"
        "tm = {}\n"
        "r = halda_solve(devs, model, kv_bits='4bit', device='cpu', lp_backend='pdhg',\n"
        "                mesh_shards=2, timings=tm)\n"
        "assert r.certified and r.k == 2 and tm['mesh_shards'] == 2, (r, tm)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "    'distilp_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                       "PYTHONPATH": str(REPO),
                                                       "HOME": str(tmp_path)})
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]


def test_the_packed_halves_and_the_device_loop_are_checked(tmp_path):
    """The packed halves and the device loop are checked modules that
    import without JAX; the loop's library is built with the others, its
    source refuses a toolkit without WHILE nodes, and the graph's launches
    and its kernels count under the names ``chip_smoke.py`` reads."""
    import subprocess
    import sys

    from distilp_torch import kernels
    from distilp_torch.kernels import build

    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for name in ("packed", "device_loop"):
        assert f"distilp_torch/solver/{name}.py" in files
    assert build.SOURCES["bnb_loop"] == ("bnb_loop_kernel.cu", ["--fmad=false"])
    src = (build.CSRC / "bnb_loop_kernel.cu").read_text()
    assert "CUDART_VERSION < 12040" in src and "#error" in src
    assert "cudaGraphCondTypeWhile" in src and "cudaGraphSetConditional" in src
    for name in ("bnb_graph", "bnb_seed", "bnb_head", "bnb_control", "bnb_answer"):
        assert name in kernels.LAUNCHES
    assert "bnb_graph" in kernels.SHAPES
    code = ("import sys; import distilp_torch.solver.packed, distilp_torch.solver.device_loop; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'distilp_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, timeout=300)


SCHED_MODULES = ("__init__", "events", "fleet", "metrics", "forecast", "speculate", "faults",
                 "sim", "scheduler")
OBS_MODULES = ("trace", "flight", "export", "timeline")


def test_the_scheduler_and_tracing_copies_are_checked_and_serve_without_jax(tmp_path):
    import subprocess
    import sys

    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for name in SCHED_MODULES:
        assert f"distilp_torch/sched/{name}.py" in files
    for name in OBS_MODULES:
        path = REPO / "distilp_torch" / "obs" / f"{name}.py"
        assert path.relative_to(REPO).as_posix() in files
        roots = {mod for _, mod in _imported_roots(path)}
        assert not roots & {"torch", "numpy", *FORBIDDEN}, (name, roots)
    for rel in ("utils/lockwatch.py", "gateway/__init__.py", "gateway/traces.py",
                "solver/plotter.py"):
        assert f"distilp_torch/{rel}" in files
    script = (
        "import sys\n"
        "from distilp_torch.cli import solver_cli\n"
        "args = ['serve', '--trace', 'tests/traces/scheduler_smoke_20.jsonl', '-p',\n"
        "        'tests/profiles/llama_3_70b/online', '--synthetic-fleet', '4',\n"
        "        '--fleet-seed', '11', '--k-candidates', '8,10', '--device', 'cpu',\n"
        "        '--fault-plan', 'tests/traces/chaos_plan.json', '--deadline-ms', '60000',\n"
        "        '--max-retries', '2', '--breaker-threshold', '2', '--chaos-check',\n"
        "        '--quiet', '--speculate', '--risk-aware', '--trace-spans-dir', sys.argv[1]]\n"
        "assert solver_cli.main(args) == 0\n"
        "assert solver_cli.main(['spans', sys.argv[1], '--quiet']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "    'distilp_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path / "spans")], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                               "HOME": str(tmp_path)})
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
    assert "chaos soak OK: 9 fault(s) injected, 4 quarantined" in proc.stdout


GATEWAY_MODULES = ("__init__", "router", "snapshot", "worker", "recovery", "procworker",
                   "gateway", "http", "loadgen", "traces")


def test_the_gateway_and_combiner_are_checked_and_serve_without_jax(tmp_path, monkeypatch):
    import subprocess
    import sys

    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for name in GATEWAY_MODULES:
        assert f"distilp_torch/gateway/{name}.py" in files
    for rel in ("combine/__init__.py", "combine/policy.py", "combine/combiner.py",
                "ops/memmodel.py"):
        assert f"distilp_torch/{rel}" in files
    assert "tests/torch_procstub.py" in files
    roots = {mod for _, mod in _imported_roots(REPO / "distilp_torch" / "ops" / "memmodel.py")}
    assert not roots & {"torch", "numpy", *FORBIDDEN}, roots
    for name in GATEWAY_MODULES:
        importlib.import_module(f"distilp_torch.gateway.{name}")
    importlib.import_module("distilp_torch.combine")

    from distilp_torch import gateway
    from distilp_torch.combine import SolveCombiner
    from distilp_torch.common import load_model_profile

    model = load_model_profile(REPO / "tests/profiles/llama_3_70b/online/model_profile.json")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: gateway.Gateway(n_workers=2), lambda: SolveCombiner(),
                 lambda: gateway.run_loadgen(model, n_fleets=1, n_workers=1),
                 lambda: gateway.Gateway(n_workers=1, worker_backend="process",
                                         scheduler_factory="tests.torch_procstub:make_scheduler")):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()
    gateway.Gateway(n_workers=2, device="cpu").close()
    SolveCombiner(device="cpu").stop()
    monkeypatch.undo()

    script = (
        "import sys\n"
        "from distilp_torch.cli import solver_cli\n"
        "args = ['serve', '--trace', 'tests/traces/gateway_smoke_10f.jsonl', '-p',\n"
        "        'tests/profiles/llama_3_70b/online', '--workers', '2', '--k-candidates',\n"
        "        '8,10', '--device', 'cpu', '--quiet', '--fail-uncertified', '--coalesce']\n"
        "assert solver_cli.main(args) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "    'distilp_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'distilp_torch.gateway.gateway' in sys.modules\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                               "HOME": str(tmp_path)})
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
    assert '"fleets": 10' in proc.stdout


A12C_A14B_MODULES = ("traffic/__init__", "traffic/arrivals", "traffic/openloop",
                     "control/__init__", "control/policy", "control/controller",
                     "obs/slo", "obs/compile_ledger", "obs/memory")


def _top_level_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_the_traffic_control_slo_and_ledgers_are_checked_and_run_without_jax(tmp_path):
    import subprocess
    import sys

    files = {p.relative_to(REPO).as_posix() for p in _port_files()}
    for name in A12C_A14B_MODULES:
        assert f"distilp_torch/{name}.py" in files
        importlib.import_module("distilp_torch." + name.replace("/", ".").removesuffix(
            ".__init__"))
    # The SLO engine and both ledgers are stdlib (+ pydantic) at import:
    # torch loads only inside the memory ledger's device reads.
    for name in ("obs/slo", "obs/compile_ledger", "obs/memory", "control/policy",
                 "control/controller"):
        roots = set(_top_level_roots(REPO / "distilp_torch" / f"{name}.py"))
        assert not roots & {"torch", "numpy", *FORBIDDEN}, (name, roots)
    script = (
        "import sys\n"
        "from distilp_torch.cli import solver_cli\n"
        "t = 'tests/traces/'\n"
        "assert solver_cli.main(['overload', '--trace', t + 'openloop_diurnal_burst.jsonl',\n"
        "    '-p', 'tests/profiles/llama_3_70b/online', '--workers', '1', '--time-scale',\n"
        "    '0.001', '--max-queue-depth', '2', '--scheduler-factory',\n"
        "    'tests.torch_procstub:make_scheduler', '--device', 'cpu', '--check',\n"
        "    '--expect-sheds', '--quiet']) == 0\n"
        "assert solver_cli.main(['slo', '--spec', t + 'slo_overload_spec.json', '--timeline',\n"
        "    t + 'slo_timeline_overload.jsonl', '--step-s', '0.1', '--expect',\n"
        "    t + 'slo_expected_alerts.json', '--check', '--quiet']) == 0\n"
        "assert solver_cli.main(['autoscale', '--timeline', t + 'slo_timeline_overload.jsonl',\n"
        "    '--policy', t + 'control_policy.json', '--spec', t + 'slo_overload_spec.json',\n"
        "    '--step-s', '0.5', '--expect', t + 'control_expected_actions.jsonl', '--check',\n"
        "    '--quiet']) == 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "    'distilp_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO, capture_output=True,
                          text=True, timeout=600,
                          env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(REPO),
                               "HOME": str(tmp_path)})
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
