#!/usr/bin/env python3
"""Time the profiler's GEMM-chain step (K9b) against ``torch.matmul`` on one
GPU, to compare two checkouts of the repository on the same card.

    python3 chip_gemm_turns.py [--root DIR] [--label NAME]

imports ``distilp_torch`` from DIR (default: the folder of this script),
loads its kernel libraries (``build.library``; they are built from DIR's
sources on first use, into DIR's build directory or DISTILP_TORCH_EXT_DIR),
and runs ``chip_smoke.gemm_turns``: float32, float16 and bfloat16 at the
chain's sizes and batches, the whole step (product and scale,
``gemm_absmax_scale``) and ``torch.matmul`` (TF32 off) in turns, the product
and the scale apart, nvidia-smi sampled through the float32 window. Prints
the card's name and power limit, then one JSON line. Run two checkouts in
one session in the order A, B, B, A and compare the same dtype, size and
batch.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times the port on a GPU", file=sys.stderr)
        return 1
    from distilp_torch.kernels import build
    from distilp_torch.profiler import device as D

    if not Path(D.__file__).resolve().is_relative_to(root):
        print(f"distilp_torch came from {D.__file__}, not {root}", file=sys.stderr)
        return 1
    # chip_smoke's helpers, from this script's folder; it puts that folder
    # first on sys.path, which the imports above no longer read.
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    card = smoke.smi_line()
    print(f"gpu: {card}", flush=True)
    t = time.perf_counter()
    build.library("profiler")
    res = {"label": args.label, "root": str(root), "card": card,
           "build_s": time.perf_counter() - t,
           "steps": smoke.gemm_turns(D, f"{args.label} " if args.label else "")}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
