"""Profiler CLI of the port (``distilp_tpu/cli/profiler_cli.py``).

``model -r <source>`` writes a ModelProfileSplit JSON; ``device -r
<source>`` microbenchmarks this host and its CUDA card and writes a
DeviceProfile JSON. ``<source>`` is a local config.json or a directory
holding one (no network). ``--device cpu`` profiles the host alone.

    python -m distilp_torch.cli.profiler_cli device -r config.json -o dev.json
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.cli.profiler_cli",
        description="Profile this device or a model analytically",
    )
    p.add_argument("kind", choices=["device", "model"])
    p.add_argument(
        "-r",
        "--repo",
        required=True,
        help="path to config.json, or a directory containing one",
    )
    p.add_argument("-o", "--output", default=None, help="output JSON path")
    p.add_argument("-s", "--seq-len", type=int, default=512)
    p.add_argument(
        "--max-batch-exp",
        type=int,
        default=6,
        help="device tables cover batches 2^0 .. 2^(N-1) (default 6)",
    )
    p.add_argument(
        "--batches",
        default=None,
        help="comma-separated batch sizes for model profiling (default 1,2,4,8)",
    )
    p.add_argument("--not-head", action="store_true", help="mark device as non-head")
    p.add_argument(
        "--raw-out",
        default=None,
        help="device profiling only: also write the raw DeviceInfo JSON "
        "(per-measurement timing spreads, memory capacity provenance, "
        "interconnect probe) that the solver-facing profile drops",
    )
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default="cuda",
        help="device profiling: the CUDA card (default) or the host alone",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.kind == "model" and args.raw_out:
        print(
            "error: --raw-out applies to device profiling only "
            "(model profiling is analytic; there is no raw DeviceInfo)",
            file=sys.stderr,
        )
        return 2

    if args.kind == "model":
        from ..profiler import profile_model

        batches = (
            [int(x) for x in args.batches.split(",") if x.strip()]
            if args.batches
            else None
        )
        profile = profile_model(
            args.repo, batch_sizes=batches, sequence_length=args.seq_len
        )
        out = Path(args.output or "model_profile.json")
    else:
        from ..profiler import profile_device

        raw_info = [] if args.raw_out else None
        profile = profile_device(
            args.repo, max_batch_exp=args.max_batch_exp,
            is_head=not args.not_head, raw_info=raw_info, device=args.device,
        )
        out = Path(args.output or f"{profile.name or 'device'}.json")
        if args.raw_out and raw_info:
            Path(args.raw_out).write_text(raw_info[0].model_dump_json(indent=2))
            print(f"Wrote raw DeviceInfo to {args.raw_out}", file=sys.stderr)

    out.write_text(profile.model_dump_json(indent=2))
    print(f"Wrote {args.kind} profile to {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
