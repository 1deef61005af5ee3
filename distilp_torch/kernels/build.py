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

from ..obs import compile_ledger as _compile_ledger

CSRC = Path(__file__).resolve().with_name("csrc")

# kernel library -> (source file, extra nvcc flags). The rounding and the
# branch-and-bound epilogue compile without FMA contraction: their float64
# ceil/floor staircases must see the same products as the plain version; so
# does the round tail, which runs both (and the threshold's product); so
# do the decomposition bound (K7), whose cell pricing has the same ones, the
# twin's Monte-Carlo engine (K8, the spill-need staircase) and the profiler's
# scale (K9b, bit for bit against its plain version; K9b's product uses
# explicit fmaf and the tensor cores, which the flag does not touch). So
# does K6b: its two routes inline the same phase code into two kernels, and
# only without contraction do both round every operation alike (bit for bit
# on the card; with it, they part at the last bit). So does the
# branch-and-bound loop's library, which re-prices the warm hint with K2's
# per-row body and runs the loop's gap tests.
SOURCES: Dict[str, tuple] = {
    "ipm": ("ipm_kernel.cu", []),
    "round": ("round_kernel.cu", ["--fmad=false"]),
    "round_moe": ("round_moe_kernel.cu", ["--fmad=false"]),
    "bnb_epilogue": ("bnb_epilogue_kernel.cu", ["--fmad=false"]),
    "pdhg": ("pdhg_kernel.cu", []),
    "pdhg_cluster": ("pdhg_cluster_kernel.cu", []),
    "decomp": ("decomp_kernel.cu", ["--fmad=false"]),
    "twin_mc": ("twin_mc_kernel.cu", ["--fmad=false"]),
    "profiler": ("profiler_kernel.cu", ["--fmad=false"]),
    "pdhg_sharded": ("pdhg_sharded_kernel.cu", ["--fmad=false"]),
    "collective": ("collective_kernel.cu", []),
    "round_tail": ("round_tail_kernel.cu", ["--fmad=false"]),
    "bnb_loop": ("bnb_loop_kernel.cu", ["--fmad=false"]),
}
HEADERS = ("common.cuh", "round_row.cuh", "epilogue_row.cuh", "per_k_row.cuh")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
              "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_D = ctypes.c_double
_S = ctypes.c_size_t
_F = ctypes.c_float
_U = ctypes.c_uint

# C signatures of the launchers (each returns a cudaError_t as int, unless
# RESTYPES says otherwise).
SIGNATURES = {
    "ipm": {
        "dtk_ipm_workspace": [_I] * 5 + [_P] * 3,
        "dtk_ipm_f32": [_P, _L, _P] + [_I] * 3 + [_P, _L] + [_P] * 10 + [_I] * 5
        + [_D] * 2 + [_P] * 15 + [_I] * 2 + [_P],
        "dtk_ipm_f64": [_P, _L, _P] + [_I] * 3 + [_P, _L] + [_P] * 10 + [_I] * 5
        + [_D] * 2 + [_P] * 15 + [_I] * 2 + [_P],
    },
    "round": {
        "dtk_round_f32": [_P, _L, _P, _P, _P, _P, _L, _I, _I, _P, _P, _P, _P],
        "dtk_round_f64": [_P, _L, _P, _P, _P, _P, _L, _I, _I, _P, _P, _P, _P],
        "dtk_round_prepare": [_I],
    },
    "round_moe": {
        "dtk_round_moe_tab_bytes": [_I, _I],
        "dtk_round_moe_f32": [_P, _L] + [_P] * 5 + [_I] * 4 + [_P] * 4 + [_P, _L, _I, _P],
        "dtk_round_moe_f64": [_P, _L] + [_P] * 5 + [_I] * 4 + [_P] * 4 + [_P, _L, _I, _P],
        "dtk_price_fixed_f64": [_P] * 7 + [_I] * 2 + [_P, _I, _P],
    },
    "decomp": {
        "dtk_decomp_eval_f32": [_P] * 5 + [_I] * 5 + [_P] * 7 + [_P],
        "dtk_decomp_ascent_grid": [_I, _I],
        "dtk_decomp_ascent_ws_bytes": [_I, _L, _I, _I],
        "dtk_decomp_ascent_f32": [_P] * 5 + [_I] * 5 + [_P, _I] + [_F] * 5 + [_P]
        + [_I] * 4 + [_P, _L, _P, _P],
        "dtk_decomp_f64_ws_bytes": [_I, _I],
        "dtk_decomp_eval_f64": [_P] * 5 + [_I] * 5 + [_P] * 3 + [_I] * 3 + [_P, _L]
        + [_P] * 5 + [_P],
        "dtk_decomp_theta_f64": [_P] * 3 + [_I] * 3 + [_P] * 5,
        "dtk_decomp_bound_f64": [_P] * 6 + [_I] * 4 + [_P, _P],
    },
    "bnb_epilogue": {
        "dtk_bnb_epilogue": [_P] * 15 + [_P] * 5 + [_I] * 3 + [_P] * 11 + [_I, _P],
        "dtk_bnb_per_k_incumbent": [_P, _P, _I, _P, _P, _P, _I] + [_P] * 4
        + [_I, _P, _I, _D] + [_P] * 5 + [_I, _I, _P],
        "dtk_bnb_per_k_rank": [_P, _I, _P, _P, _P, _I, _I] + [_P] * 3 + [_I, _I, _P],
    },
    "twin_mc": {
        "dtk_twin_mc": [_P, _I, _I] + [_D] * 10 + [_U, _U, _P, _P, _P],
    },
    "profiler": {
        "dtk_roll1": [_P, _P, _L, _I, _P],
        "dtk_gemm_tile": [_I, _L, _L, _P, _P],
        "dtk_gemm_absmax_f32": [_P] * 3 + [_L] * 3 + [_P, _P],
        "dtk_gemm_absmax_f16": [_P] * 3 + [_L] * 3 + [_P, _P],
        "dtk_gemm_absmax_bf16": [_P] * 3 + [_L] * 3 + [_P, _P],
        "dtk_absmax_rescale_f32": [_P, _L, _P, _I, _F, _I, _P],
        "dtk_absmax_rescale_f16": [_P, _L, _P, _I, _F, _I, _P],
        "dtk_absmax_rescale_bf16": [_P, _L, _P, _I, _F, _I, _P],
    },
    "pdhg": {
        "dtk_pdhg_grid": [_I],
        "dtk_pdhg_ws_bytes": [_I] * 4,
        "dtk_pdhg_elem_f32": [_P, _I, _P, _L] + [_P] * 8 + [_I] * 5 + [_D] * 2 + [_P, _L, _I]
        + [_P] * 13 + [_I, _P],
        "dtk_pdhg_elem_f64": [_P, _I, _P, _L] + [_P] * 8 + [_I] * 5 + [_D] * 2 + [_P, _L, _I]
        + [_P] * 13 + [_I, _P],
    },
    "pdhg_cluster": {
        "dtk_pdhgc_max_cluster": [_I],
        "dtk_pdhgc_prepare": [_I],
        "dtk_pdhgc_smem_bytes": [_I] * 7,
        "dtk_pdhgc_f32": [_P, _P, _I, _I, _P, _L] + [_P] * 8 + [_I] * 5 + [_D] * 2 + [_I, _I]
        + [_P] * 13 + [_I, _P],
        "dtk_pdhgc_f64": [_P, _P, _I, _I, _P, _L] + [_P] * 8 + [_I] * 5 + [_D] * 2 + [_I, _I]
        + [_P] * 13 + [_I, _P],
    },
    "pdhg_sharded": {
        "dtk_pdhgs_grid": [_I],
        "dtk_pdhgs_ws_bytes": [_I] * 5,
        "dtk_pdhgs_f32": [_I, _P, _P, _P, _L, _P],
        "dtk_pdhgs_f64": [_I, _P, _P, _P, _L, _P],
        "dtk_pdhgs_elem_grid": [_I],
        "dtk_pdhgs_elem_f32": [_I, _P, _P, _P, _L, _P],
        "dtk_pdhgs_elem_f64": [_I, _P, _P, _P, _L, _P],
        "dtk_pdhgs_fused_grid": [_I, _I],
        "dtk_pdhgs_fused_max_shards": [],
        "dtk_pdhgs_fused_f32": [_I, _P, _P, _P, _P, _I, _P],
        "dtk_pdhgs_fused_f64": [_I, _P, _P, _P, _P, _I, _P],
        "dtk_pdhgs_elem_fused_f32": [_I, _P, _P, _P, _P, _I, _P],
        "dtk_pdhgs_elem_fused_f64": [_I, _P, _P, _P, _P, _I, _P],
    },
    "collective": {
        "dtk_allreduce_f32": [_P, _I, _L, _I, _P, _P],
        "dtk_allreduce_f64": [_P, _I, _L, _I, _P, _P],
    },
    "round_tail": {
        "dtk_round_tail_smem_bytes": [_I] * 6,
        "dtk_round_tail_ws_bytes": [_I] * 4,
        "dtk_round_tail": [_P, _P, _D, _P],
    },
    "bnb_loop": {
        "dtk_bnb_seed_smem": [_I, _I],
        "dtk_bnb_seed": [_P, _P, _P],
        "dtk_bnb_seed_moe_smem": [_I],
        "dtk_bnb_seed_moe": [_P, _P, _P],
        "dtk_bnb_head": [_P, _P, _P],
        "dtk_bnb_cast": [_P, _P, _P],
        "dtk_bnb_gather": [_P, _P, _P],
        "dtk_bnb_control": [_P, _P, _D, ctypes.c_ulonglong, _P],
        "dtk_bnb_answer": [_P, _P, _P],
        "dtk_bnb_graph_new": [ctypes.POINTER(_P), ctypes.POINTER(ctypes.c_ulonglong)],
        "dtk_bnb_capture_begin": [_P],
        "dtk_bnb_capture_end": [_P, ctypes.POINTER(_P)],
        "dtk_bnb_graph_finish": [_P] * 4,
        "dtk_bnb_graph_launch": [_P, _P],
        "dtk_bnb_graph_free": [_P],
        "dtk_bnb_graph_discard": [_P],
    },
}
RESTYPES = {"dtk_pdhg_ws_bytes": _S, "dtk_pdhgs_ws_bytes": _S, "dtk_pdhgc_smem_bytes": _S,
            "dtk_decomp_ascent_ws_bytes": _S, "dtk_decomp_f64_ws_bytes": _S,
            "dtk_round_moe_tab_bytes": _L, "dtk_round_tail_smem_bytes": _L,
            "dtk_round_tail_ws_bytes": _L, "dtk_bnb_seed_smem": _L, "dtk_bnb_seed_moe_smem": _L,
            "dtk_bnb_graph_free": None, "dtk_bnb_graph_discard": None}

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


def _compile(nvcc: str, name: str, out_dir: Path) -> tuple:
    """(library path, whether nvcc ran for it, ms): a library whose hash is
    already in ``out_dir`` is reused."""
    t0 = time.perf_counter()
    path, ran = _build(nvcc, name, out_dir)
    return path, ran, (time.perf_counter() - t0) * 1e3


def _build(nvcc: str, name: str, out_dir: Path) -> tuple:
    src, extra = SOURCES[name]
    h = hashlib.sha256()
    for f in (src, *HEADERS):
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(ARCH + BASE_FLAGS + extra).encode())
    lib = out_dir / f"lib{name}_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, False
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
    return lib, True


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
            built = dict(
                zip(SOURCES, ex.map(lambda n: _compile(nvcc, n, out_dir), SOURCES))
            )
        BUILD_STATS["build_s"] = time.perf_counter() - t0
        # nvcc runs of this process (0 when every library was in the cache:
        # a gateway's worker process reuses what its parent built).
        BUILD_STATS["nvcc_runs"] = sum(ran for _, ran, _ in built.values())
        for name, (path, ran, ms) in built.items():
            t1 = time.perf_counter()
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = RESTYPES.get(fn, ctypes.c_int)
            _LIBS[name] = lib
            # One compile-ledger event a library: its build (or cache
            # lookup) and its load.
            _compile_ledger.note_build(name, path.stem.rsplit("_", 1)[-1],
                                       ms + (time.perf_counter() - t1) * 1e3, ran)
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
            lines = [ln for ln in log.read_text().splitlines()
                     if "ptxas" in ln or "spill" in ln]
            parts.append(f"[{name}]\n" + "\n".join(lines))
    return "\n".join(parts)
