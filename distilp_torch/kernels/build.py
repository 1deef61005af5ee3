"""Build the port's CUDA kernels from the sources in ``csrc/`` at first use.

Each ``csrc/*.cu`` file is one ``nvcc`` run (all started together) into a
shared library with a plain C interface, loaded with ``ctypes``: no PyTorch
header is compiled, so a cold build takes seconds, not minutes. Libraries are
keyed by the hash of their sources and flags and cached under
``.cache/distilp_torch_ext/`` at the repository root (override with
``DISTILP_TORCH_EXT_DIR``), so a second process reuses them.

A build or load failure raises; nothing falls back to the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().with_name("csrc")

# kernel library -> (source file, extra nvcc flags). The rounding and the
# branch-and-bound epilogue compile without FMA contraction: their float64
# ceil/floor staircases must see the same products as the plain version; so
# does the decomposition bound (K7), whose cell pricing has the same ones.
SOURCES: Dict[str, tuple] = {
    "ipm": ("ipm_kernel.cu", []),
    "round": ("round_kernel.cu", ["--fmad=false"]),
    "round_moe": ("round_moe_kernel.cu", ["--fmad=false"]),
    "bnb_epilogue": ("bnb_epilogue_kernel.cu", ["--fmad=false"]),
    "pdhg": ("pdhg_kernel.cu", []),
    "decomp": ("decomp_kernel.cu", ["--fmad=false"]),
}
HEADERS = ("common.cuh",)
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_D = ctypes.c_double
_S = ctypes.c_size_t
_F = ctypes.c_float

# C signatures of the launchers (each returns a cudaError_t as int, unless
# RESTYPES says otherwise).
SIGNATURES = {
    "ipm": {
        "dtk_ipm_vec_ws_bytes": [_I] * 5 + [_P],
        "dtk_ipm_f32": [_P] * 2 + [_L] + [_P] * 10 + [_I] * 5 + [_D] * 2
        + [_P] * 14 + [_I, _P],
        "dtk_ipm_f64": [_P] * 2 + [_L] + [_P] * 10 + [_I] * 5 + [_D] * 2
        + [_P] * 14 + [_I, _P],
    },
    "round": {
        "dtk_round_f32": [_P, _L, _P, _P, _P, _I, _I, _P, _P, _P, _P],
        "dtk_round_f64": [_P, _L, _P, _P, _P, _I, _I, _P, _P, _P, _P],
    },
    "round_moe": {
        "dtk_round_moe_f32": [_P, _L] + [_P] * 4 + [_I] * 4 + [_P] * 4 + [_I, _P],
        "dtk_round_moe_f64": [_P, _L] + [_P] * 4 + [_I] * 4 + [_P] * 4 + [_I, _P],
    },
    "decomp": {
        "dtk_decomp_eval_f32": [_P, _F, _F, _P, _P] + [_I] * 4 + [_P] * 7 + [_P],
        "dtk_decomp_eval_f64": [_P, _D, _D, _P, _P] + [_I] * 4 + [_P] * 3 + [_I]
        + [_P] * 4 + [_P],
    },
    "bnb_epilogue": {
        "dtk_bnb_epilogue": [_P] * 13 + [_D] + [_P] * 5 + [_I] * 3 + [_P] * 11
        + [_I, _P],
    },
    "pdhg": {
        "dtk_pdhg_ws_bytes": [_I] * 4,
        "dtk_pdhg_f32": [_P] * 10 + [_I] * 5 + [_D] * 2 + [_P, _L] + [_P] * 13,
        "dtk_pdhg_f64": [_P] * 10 + [_I] * 5 + [_D] * 2 + [_P, _L] + [_P] * 13,
    },
}
RESTYPES = {"dtk_pdhg_ws_bytes": _S}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
BUILD_STATS: Dict[str, float] = {}


def build_dir() -> Path:
    env = os.environ.get("DISTILP_TORCH_EXT_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / ".cache" / "distilp_torch_ext"


def _nvcc() -> str:
    candidates = [os.environ.get("NVCC"), shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if home:
            candidates.append(str(Path(home) / "bin" / "nvcc"))
    for c in candidates:
        if c and Path(c).is_file():
            return c
    raise RuntimeError(
        "nvcc not found (set NVCC or CUDA_HOME): the CUDA kernels of "
        "distilp_torch are built from source at first use"
    )


def _compile(nvcc: str, name: str, out_dir: Path) -> Path:
    src, extra = SOURCES[name]
    h = hashlib.sha256()
    for f in (src, *HEADERS):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(ARCH + BASE_FLAGS + extra).encode())
    lib = out_dir / f"lib{name}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [nvcc, *ARCH, *BASE_FLAGS, *extra, "-o", str(tmp), str(CSRC / src)],
        capture_output=True, text=True, check=False,
    )
    (out_dir / f"{name}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on {src} (exit {proc.returncode}):\n"
            f"{proc.stderr[-6000:]}"
        )
    os.replace(tmp, lib)
    return lib


def load_all() -> Dict[str, ctypes.CDLL]:
    """Build (or reuse) and load every kernel library; idempotent."""
    with _LOCK:
        if _LIBS:
            return _LIBS
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(SOURCES)) as ex:
            paths = dict(
                zip(SOURCES, ex.map(lambda n: _compile(nvcc, n, out_dir), SOURCES))
            )
        BUILD_STATS["build_s"] = time.perf_counter() - t0
        for name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = RESTYPES.get(fn, ctypes.c_int)
            _LIBS[name] = lib
        return _LIBS


def library(name: str) -> ctypes.CDLL:
    return load_all()[name]


def ptxas_report() -> str:
    """What ``-Xptxas -v`` said for each kernel (registers, shared memory,
    spills) in the last build of this process's build directory."""
    parts = []
    for name in SOURCES:
        log = build_dir() / f"{name}.log"
        if log.exists():
            lines = [ln for ln in log.read_text().splitlines() if "ptxas" in ln]
            parts.append(f"[{name}]\n" + "\n".join(lines))
    return "\n".join(parts)
