"""Rules of the PyTorch/CUDA port, checked on its source.

- No module of ``distilp_torch`` (its model profiler included) and not
  ``chip_smoke.py`` imports JAX or anything of the JAX package
  (``distilp_tpu``), jax-free modules included: the port keeps its own
  copies.
- ``triton``/kernel builds never happen at import time: importing every
  module of the port works on a host without nvcc or a GPU.
- Every kernel source named by the build exists, and each kernel wrapper
  counts its launches under the name ``chip_smoke.py`` reads.
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
    return files + [REPO / "chip_smoke.py"]


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
    for name in ("__init__", "analytic", "api", "hfconfig"):
        assert f"distilp_torch/profiler/{name}.py" in files
    from distilp_torch.profiler import load_config, load_config_from_repo

    with pytest.raises(RuntimeError, match="local config path"):
        load_config("mistralai/Mixtral-8x7B-v0.1")
    with pytest.raises(RuntimeError, match="local config path"):
        load_config_from_repo(str(tmp_path / "missing"))
    cfg = load_config(REPO / "tests" / "configs" / "mixtral_8x7b.json")
    assert cfg.raw["model_type"] == "mixtral"


def test_every_port_module_imports_without_a_gpu():
    import distilp_torch

    names = [m.name for m in pkgutil.walk_packages(distilp_torch.__path__, "distilp_torch.")]
    assert "distilp_torch.solver.backend_torch" in names
    assert "distilp_torch.profiler.analytic" in names
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
