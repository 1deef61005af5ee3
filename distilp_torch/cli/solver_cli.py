"""Solver CLI of the port (``distilp_tpu/cli/solver_cli.py``, two parts).

One-shot solve of a profile folder (``model_profile.json`` + one JSON per
device; the head device is whichever sorts first):

    python -m distilp_torch.cli.solver_cli -p <folder> [--backend torch|cpu]

the digital-twin report of a placement:

    python -m distilp_torch.cli.solver_cli evaluate -p <folder> [--solution S]

and the solver's convergence report of one solve (per-round search log and
the root LP relaxations' per-chunk traces, optionally exported as JSONL):

    python -m distilp_torch.cli.solver_cli diagnose -p <folder> [--out F | --load F]

the scheduler daemon over a churn trace (``distilp_torch.sched``), through
the gateway tier for many fleets (``distilp_torch.gateway``: ``--workers``,
process workers, snapshot and resume, ``--listen`` ...), and the conversion
of its span JSONL into Chrome trace-event JSON:

    python -m distilp_torch.cli.solver_cli serve --trace T -p <folder> [...]
    python -m distilp_torch.cli.solver_cli spans <spans.jsonl | dir> [--stats]

open-loop overload against the gateway's admission control, the SLO
engine's offline replay, the autoscaler's offline replay, and the compile
and memory ledgers' reports:

    python -m distilp_torch.cli.solver_cli overload --trace T -p <folder> [...]
    python -m distilp_torch.cli.solver_cli slo --timeline F --spec S [--expect E]
    python -m distilp_torch.cli.solver_cli autoscale --timeline F --policy P [...]
    python -m distilp_torch.cli.solver_cli compiles --load F | --trace T -p <folder>
    python -m distilp_torch.cli.solver_cli memory --load F | --trace T -p <folder>

``--backend torch`` (default) runs the branch-and-bound search on
``--device`` (default cuda; ``cpu`` runs the kernels' plain versions),
``--backend cpu`` the HiGHS oracle. ``--per-k`` certifies every k and prints
the k-curve; ``--expert-loads`` runs the load-aware routing loop; ``--plot``
draws the k-objective curve. The twin's Monte-Carlo engine, ``serve``'s and
``overload``'s every solve run on ``--device`` too.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def _add_device(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", choices=["cuda", "cpu"], default=None,
        help="device of the torch backend and of the twin's Monte-Carlo "
        "engine (default cuda; cpu runs the kernels' plain versions)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.cli.solver_cli",
        description="HALDA placement solver over a folder of device/model profiles",
    )
    p.add_argument(
        "--profile",
        "-p",
        required=True,
        help="folder containing model_profile.json and per-device JSONs",
    )
    p.add_argument("--backend", choices=["torch", "cpu"], default="torch")
    _add_device(p)
    p.add_argument("--mip-gap", type=float, default=1e-4)
    p.add_argument("--kv-bits", default="4bit", help="4bit | 8bit | fp16 | bf16")
    p.add_argument("--time-limit", type=float, default=3600.0, help="per-k seconds (cpu backend)")
    p.add_argument(
        "--k-candidates",
        default=None,
        help="comma-separated k values (default: all proper factors of L)",
    )
    p.add_argument("--plot", action="store_true", help="plot the k-objective curve")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--save-solution", default=None, help="write the solution JSON here")
    p.add_argument(
        "--moe",
        choices=["auto", "on", "off"],
        default="auto",
        help="expert+layer co-assignment: auto (when the profile has MoE "
        "component metrics), on (require them), off (dense formulation)",
    )
    p.add_argument(
        "--warm-from",
        default=None,
        help="warm-start from a solution JSON written by --save-solution "
        "(torch backend): the stored assignment is re-priced exactly under "
        "the current profiles and seeds the search; stored Lagrangian duals "
        "make a MoE re-solve re-evaluate its bound instead of the ascent",
    )
    p.add_argument(
        "--expert-loads",
        default=None,
        help="load-weighted expert routing: a JSON file with one relative "
        "load per routed expert (or inline comma-separated values). Runs "
        "the solve->map->re-price loop and prints the expert->device "
        "mapping (MoE profiles only; see solver/routing.py)",
    )
    p.add_argument("--max-rounds", type=int, default=None,
                   help="branch-and-bound round budget (torch backend)")
    p.add_argument("--beam", type=int, default=None,
                   help="frontier rows given an LP solve per round (torch backend)")
    p.add_argument("--ipm-iters", type=int, default=None,
                   help="interior-point iterations per LP relaxation (torch backend)")
    p.add_argument(
        "--ipm-warm-iters", type=int, default=None,
        help="IPM budget of rounds after the root (torch backend)",
    )
    p.add_argument("--node-cap", type=int, default=None,
                   help="frontier capacity; overflow floors the certificate (torch backend)")
    p.add_argument(
        "--lp-backend", choices=["ipm", "pdhg", "auto"], default="auto",
        help="LP relaxation engine (torch backend): ipm, pdhg, or auto = "
        "pdhg at 128 devices and more, ipm below (default)",
    )
    p.add_argument("--pdhg-iters", type=int, default=None,
                   help="first-order iterations per LP relaxation (pdhg engine)")
    p.add_argument("--pdhg-restart-tol", type=float, default=None,
                   help="Halpern restart sufficient-decay factor in (0, 1) (pdhg engine)")
    p.add_argument(
        "--mesh-shards", type=int, default=None,
        help="row-partition every PDHG LP relaxation across this many shards "
        "(the first GPUs; with fewer visible, a virtual mesh whose shards share "
        "them, which the CLI declares itself)",
    )
    p.add_argument("--pdhg-dtype", choices=["f32", "f64"], default=None,
                   help="first-order iterate precision (pdhg engine)")
    p.add_argument(
        "--batch-size", type=int, default=1,
        help="price dense compute at the profiles' b_N throughput column",
    )
    p.add_argument(
        "--per-k", action="store_true",
        help="solve every feasible segment count to its own certificate and "
        "print the k-curve with assignments (torch backend: one sweep; cpu "
        "backend: one HiGHS solve per k)",
    )
    return p


def _k_candidates(text):
    if not text:
        return None
    return [int(x) for x in text.split(",") if x.strip()]


def build_evaluate_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.cli.solver_cli evaluate",
        description="digital-twin evaluation of a placement: deterministic "
        "simulated execution + seeded Monte-Carlo robustness report "
        "(latency quantiles under device drift, feasibility-violation "
        "probability, worst-device sensitivity ranking; see "
        "distilp_torch.twin)",
    )
    p.add_argument(
        "--profile",
        "-p",
        required=True,
        help="folder containing model_profile.json and per-device JSONs",
    )
    p.add_argument(
        "--solution",
        default=None,
        help="placement JSON previously written by --save-solution (by "
        "either package's CLI); default: solve first",
    )
    p.add_argument("--backend", choices=["torch", "cpu"], default="torch")
    _add_device(p)
    p.add_argument("--mip-gap", type=float, default=1e-3)
    p.add_argument("--kv-bits", default="4bit")
    p.add_argument(
        "--k-candidates",
        default=None,
        help="comma-separated k values (used when solving; default: all "
        "proper factors of L)",
    )
    p.add_argument(
        "--moe",
        choices=["auto", "on", "off"],
        default="auto",
        help="expert+layer co-assignment mode the placement was solved with",
    )
    p.add_argument("--samples", type=int, default=1024, help="Monte-Carlo draws")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sigma-compute", type=float, default=0.08)
    p.add_argument("--sigma-comm", type=float, default=0.15)
    p.add_argument("--sigma-disk", type=float, default=0.10)
    p.add_argument(
        "--sigma-mem", type=float, default=0.0,
        help="memory-headroom jitter; >0 makes the feasibility-violation "
        "probability a real tail statistic instead of a 0/1 flag",
    )
    p.add_argument(
        "--dropout-p", type=float, default=0.0,
        help="per-device straggler probability per sample (device runs "
        "--dropout-slowdown x slower)",
    )
    p.add_argument("--dropout-slowdown", type=float, default=8.0)
    p.add_argument(
        "--json", action="store_true",
        help="print the two reports as one JSON object instead of text",
    )
    p.add_argument(
        "--check-determinism",
        action="store_true",
        help="run the Monte-Carlo report twice with the same seed and fail "
        "unless the reports are identical",
    )
    return p


def evaluate_main(argv=None) -> int:
    """``evaluate``: render the digital-twin report for a placement."""
    args = build_evaluate_parser().parse_args(argv)

    from ..common import load_from_profile_folder

    folder = Path(args.profile)
    if not folder.is_dir():
        print(f"error: {folder} is not a directory", file=sys.stderr)
        return 2
    if args.samples < 1:
        print(f"error: --samples must be >= 1 (got {args.samples})", file=sys.stderr)
        return 2
    devices, model = load_from_profile_folder(folder)
    moe = {"auto": None, "on": True, "off": False}[args.moe]

    from ..solver import HALDAResult, halda_solve

    if args.solution:
        try:
            result = HALDAResult.model_validate(
                json.loads(Path(args.solution).read_text())
            )
        except (OSError, TypeError, ValueError) as e:
            print(f"error: cannot load --solution: {e}", file=sys.stderr)
            return 2
        # Structural validation against THIS fleet and model: a solution
        # saved for another fleet would crash mid-report or be mispriced.
        from ..twin import build_twin_arrays, placement_applicable

        try:
            arrays = build_twin_arrays(devices, model, kv_bits=args.kv_bits, moe=moe)
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if not placement_applicable(arrays, result.w, result.n, y=result.y, k=result.k):
            print(
                "error: the saved solution cannot execute on this profile "
                f"folder (devices={len(devices)}, L={model.L}, "
                f"moe={'on' if arrays.moe else 'off'}): check device "
                "count, window sums, offload counts and expert cover — "
                "was it solved for a different fleet/model, or with a "
                "different --moe mode?",
                file=sys.stderr,
            )
            return 2
    else:
        try:
            result = halda_solve(
                devices,
                model,
                k_candidates=_k_candidates(args.k_candidates),
                mip_gap=args.mip_gap,
                kv_bits=args.kv_bits,
                backend=args.backend,
                moe=moe,
                device=args.device,
            )
        except (ValueError, RuntimeError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    from ..twin import evaluate_placement, robustness_report

    evaluation = evaluate_placement(devices, model, result, kv_bits=args.kv_bits, moe=moe)
    mc_kwargs = dict(
        samples=args.samples,
        seed=args.seed,
        kv_bits=args.kv_bits,
        moe=moe,
        sigma_compute=args.sigma_compute,
        sigma_comm=args.sigma_comm,
        sigma_disk=args.sigma_disk,
        sigma_mem=args.sigma_mem,
        dropout_p=args.dropout_p,
        dropout_slowdown=args.dropout_slowdown,
        device=args.device,
    )
    report = robustness_report(devices, model, result, **mc_kwargs)
    if args.check_determinism:
        report2 = robustness_report(devices, model, result, **mc_kwargs)
        if report.model_dump() != report2.model_dump():
            print(
                "error: Monte-Carlo report is not deterministic for a fixed seed",
                file=sys.stderr,
            )
            return 1

    if args.json:
        print(json.dumps({
            "evaluation": evaluation.model_dump(),
            "robustness": report.model_dump(),
        }))
    else:
        print(evaluation.render_text())
        print()
        print(report.render_text())

    # The conformance contract: the twin's unperturbed execution agrees with
    # the objective the placement was priced at. A reloaded solution under
    # drifted profiles legitimately disagrees, so only an in-process solve
    # gates the exit code.
    if args.solution is None and evaluation.rel_err is not None:
        if evaluation.rel_err > 1e-6:
            print(
                f"error: twin latency {evaluation.latency_s:.9f} disagrees "
                f"with the solver objective {evaluation.objective_s:.9f} "
                f"(rel err {evaluation.rel_err:.3e})",
                file=sys.stderr,
            )
            return 1
    return 0


def build_diagnose_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.cli.solver_cli diagnose",
        description="solver-interior convergence report: run one HALDA solve "
        "with its telemetry on (the per-branch-and-bound-round search log and "
        "the root LP relaxations' per-chunk residual/restart traces), render "
        "the per-round tables, and optionally export the report as JSONL "
        "(reload with --load). The solve itself is the normal certified "
        "solve",
    )
    p.add_argument(
        "--profile", "-p", default=None,
        help="folder containing model_profile.json and per-device JSONs "
        "(required unless --load)",
    )
    p.add_argument(
        "--synthetic-fleet", type=int, default=0, metavar="M",
        help="solve M synthetic devices instead of the folder's device JSONs "
        "(the 16-device north star: --synthetic-fleet 16 --fleet-seed 123)",
    )
    p.add_argument("--fleet-seed", type=int, default=0)
    _add_device(p)
    p.add_argument("--mip-gap", type=float, default=1e-3)
    p.add_argument("--kv-bits", default="4bit")
    p.add_argument(
        "--k-candidates", default=None,
        help="comma-separated k values (default: all proper factors of L)",
    )
    p.add_argument(
        "--moe", choices=["auto", "on", "off"], default="auto",
        help="expert+layer co-assignment mode (see the solver's --moe)",
    )
    p.add_argument(
        "--lp-backend", choices=["ipm", "pdhg", "auto"], default="auto",
        help="LP relaxation engine to diagnose (its traces carry the engine's "
        "own gauges: the complementarity mu for ipm, the normalized duality "
        "gap and the Halpern restart cadence for pdhg)",
    )
    p.add_argument("--pdhg-iters", type=int, default=None)
    p.add_argument("--pdhg-restart-tol", type=float, default=None)
    p.add_argument("--max-rounds", type=int, default=None)
    p.add_argument("--beam", type=int, default=None)
    p.add_argument("--ipm-iters", type=int, default=None)
    p.add_argument("--ipm-warm-iters", type=int, default=None)
    p.add_argument("--node-cap", type=int, default=None)
    p.add_argument(
        "--out", default=None, metavar="FILE",
        help="also export the report as JSONL (one 'search' header line, one "
        "'round' line per round, one 'lp' line per root trace)",
    )
    p.add_argument(
        "--load", default=None, metavar="FILE",
        help="render a previously exported JSONL report (of either package) "
        "instead of solving",
    )
    p.add_argument(
        "--json", action="store_true",
        help="print the full report as one JSON object (SearchTrace fields + "
        "digest + solver timings) instead of tables",
    )
    return p


def diagnose_main(argv=None) -> int:
    """``diagnose``: one solve with its telemetry -> convergence report."""
    args = build_diagnose_parser().parse_args(argv)

    from ..obs.convergence import (
        build_search_trace,
        search_trace_from_jsonl,
        search_trace_to_jsonl,
    )

    tm: dict = {}
    if args.load:
        try:
            trace = search_trace_from_jsonl(Path(args.load).read_text())
        except (OSError, ValueError, TypeError) as e:
            print(f"error: cannot load {args.load}: {e}", file=sys.stderr)
            return 2
    else:
        if not args.profile:
            print("error: --profile is required unless --load", file=sys.stderr)
            return 2
        from ..common import load_from_profile_folder, load_model_profile
        from ..solver import halda_solve
        from ..utils import make_synthetic_fleet

        folder = Path(args.profile)
        if not folder.is_dir():
            print(f"error: {folder} is not a directory", file=sys.stderr)
            return 2
        if args.synthetic_fleet > 0:
            model = load_model_profile(folder / "model_profile.json")
            devices = make_synthetic_fleet(args.synthetic_fleet, seed=args.fleet_seed)
        else:
            devices, model = load_from_profile_folder(folder)
        conv: dict = {}
        try:
            halda_solve(
                devices, model, k_candidates=_k_candidates(args.k_candidates),
                mip_gap=args.mip_gap, kv_bits=args.kv_bits,
                moe={"auto": None, "on": True, "off": False}[args.moe],
                max_rounds=args.max_rounds, beam=args.beam, ipm_iters=args.ipm_iters,
                ipm_warm_iters=args.ipm_warm_iters, node_cap=args.node_cap,
                lp_backend=args.lp_backend, pdhg_iters=args.pdhg_iters,
                pdhg_restart_tol=args.pdhg_restart_tol, timings=tm, convergence=conv,
                device=args.device,
            )
        except (ValueError, RuntimeError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        trace = build_search_trace(conv)

    if not trace.rounds:
        print(
            "error: empty convergence report (no branch-and-bound round executed: "
            "was the sweep structurally infeasible?)",
            file=sys.stderr,
        )
        return 1
    if args.json:
        payload = trace.model_dump()
        payload["digest"] = trace.digest()
        if tm:
            payload["timings"] = {k: v for k, v in tm.items()
                                  if isinstance(v, (int, float, str, bool))}
        print(json.dumps(payload))
    else:
        print(trace.render_text())
        if tm.get("solve_ms") is not None:
            print(
                f"solve: {tm.get('solve_ms', 0.0):.1f} ms of search (upload "
                f"{tm.get('upload_ms', 0.0):.1f} ms)"
                + (" [escalated]" if tm.get("escalated") else "")
            )
    if args.out:
        Path(args.out).write_text(search_trace_to_jsonl(trace))
        if not args.json:
            print(f"wrote {args.out}")
    return 0



# -- serve: the scheduler daemon over a churn trace --------------------------

def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.cli.solver_cli serve",
        description="run the fleet scheduler service over a churn trace "
        "(see distilp_torch.sched): events in, certified placements out, "
        "warm solver state kept across ticks",
    )
    p.add_argument(
        "--trace", required=True,
        help="JSONL churn trace (one event per line; see sched.events for "
        "the schema, sched.sim / `generate_trace` to make one)",
    )
    p.add_argument(
        "--profile", "-p", required=True,
        help="profile folder; model_profile.json is the served model, the "
        "device JSONs are the starting fleet unless --synthetic-fleet",
    )
    p.add_argument(
        "--synthetic-fleet", type=int, default=0, metavar="M",
        help="start from M synthetic devices instead of the folder's device "
        "JSONs (deterministic; see utils.make_synthetic_fleet)",
    )
    p.add_argument("--fleet-seed", type=int, default=0)
    p.add_argument("--backend", choices=["torch", "cpu"], default="torch")
    _add_device(p)
    p.add_argument("--mip-gap", type=float, default=1e-3)
    p.add_argument("--kv-bits", default="4bit")
    p.add_argument(
        "--k-candidates", default=None,
        help="comma-separated k values (default: all proper factors of L)",
    )
    p.add_argument(
        "--warm-pool", type=int, default=4,
        help="max warm replanners kept (LRU over (fleet, model) identities)",
    )
    p.add_argument(
        "--cold-start", action="store_true",
        help="A/B debugging: disable every cross-tick warm path (incumbent "
        "seed, Lagrangian duals, root LP iterates, margin chain)",
    )
    p.add_argument(
        "--lp-backend", choices=["ipm", "pdhg", "auto"], default="auto",
        help="LP relaxation engine per tick (torch backend); the engine each "
        "tick ran is counted (lp_backend_ipm/lp_backend_pdhg)",
    )
    p.add_argument("--pdhg-iters", type=int, default=None,
                   help="first-order iterations per LP relaxation (pdhg engine)")
    p.add_argument("--pdhg-restart-tol", type=float, default=None,
                   help="Halpern restart sufficient-decay factor (pdhg engine)")
    p.add_argument(
        "--mesh-shards", type=int, default=None,
        help="row-partition every tick's PDHG LP relaxations across this many "
        "shards (with fewer GPUs visible, a virtual mesh the CLI declares)",
    )
    p.add_argument("--pdhg-dtype", choices=["f32", "f64"], default=None,
                   help="first-order iterate precision per tick (pdhg engine)")
    p.add_argument(
        "--risk-aware", action="store_true",
        help="risk-aware serving: score the fresh solve, the warm pool's "
        "incumbents and the per-k optima on the digital twin (seeded "
        "Monte-Carlo p95 + violation penalty) and serve the lowest-risk one",
    )
    p.add_argument("--risk-samples", type=int, default=256,
                   help="Monte-Carlo samples per risk-aware candidate score")
    p.add_argument("--risk-seed", type=int, default=0,
                   help="seed of the risk-aware perturbation draws")
    p.add_argument(
        "--speculate", action="store_true",
        help="speculative replanning: forecast drift from the applied events, "
        "pre-solve the K most likely near futures as one scenario batch after "
        "each tick (off the serving path), and serve a matching event from "
        "the pre-solved bank (mode='spec')",
    )
    p.add_argument("--spec-k", type=int, default=3,
                   help="forecast candidates pre-solved per speculation batch")
    p.add_argument("--spec-tolerance", type=float, default=0.05,
                   help="relative tolerance of the speculation bank's instance digest")
    p.add_argument(
        "--fail-uncertified", action="store_true",
        help="exit 1 if any structural event's placement misses its "
        "optimality certificate",
    )
    p.add_argument(
        "--deadline-ms", type=float, default=None,
        help="per-tick wall-clock solve deadline: an overrunning solve is "
        "abandoned and the last-known-good placement served (mode='stale'); "
        "the first solve is exempt",
    )
    p.add_argument("--max-retries", type=int, default=0,
                   help="solve retries per tick with bounded exponential backoff")
    p.add_argument(
        "--breaker-threshold", type=int, default=None,
        help="consecutive solve failures that open the circuit breaker "
        "(default 5; 0 disables)",
    )
    p.add_argument("--fault-plan", default=None,
                   help="chaos mode: a FaultPlan JSON (see sched.faults) injected "
                   "over the replay")
    p.add_argument("--fault-seed", type=int, default=None,
                   help="override the fault plan's seed")
    p.add_argument(
        "--chaos-check", action="store_true",
        help="exit 1 unless the chaos soak contract holds (a valid placement "
        "on every tick, every poisoned event quarantined, health recovered)",
    )
    p.add_argument("--metrics-out", default=None,
                   help="write the final metrics snapshot + replay summary JSON here")
    p.add_argument("--quiet", action="store_true", help="summary line only")
    p.add_argument(
        "--trace-spans-dir", default=None, metavar="DIR",
        help="span tracing: record every event's span tree (tick -> solve -> "
        "publish) to DIR/spans.jsonl; convert with the `spans` subcommand",
    )
    p.add_argument(
        "--flight-dir", default=None, metavar="DIR",
        help="flight recorder: a ring of the last N tick records, dumped to a "
        "post-mortem JSONL in DIR on breaker-open or a chaos violation",
    )
    p.add_argument("--flight-capacity", type=int, default=128,
                   help="tick records kept in the flight recorder's ring")
    p.add_argument(
        "--profile-dir", default=None, metavar="DIR",
        help="wrap the FIRST solve tick in torch.profiler and write its Chrome "
        "trace to DIR/solve_profile.json",
    )
    p.add_argument(
        "--solver-diagnostics", action="store_true",
        help="solver-interior telemetry per tick: the conv_* digest rides the "
        "sched.solve span and the flight records",
    )
    p.add_argument(
        "--timeline-dir", default=None, metavar="DIR",
        help="sample the scheduler's metrics at a fixed cadence and dump the "
        "timeline to DIR/timeline.jsonl at exit",
    )
    p.add_argument("--timeline-period-ms", type=float, default=100.0,
                   help="timeline sampler cadence (ms)")
    p.add_argument(
        "--slo", default=None, metavar="SPEC.json",
        help="attach the SLO engine: a fixed-cadence sampler snapshots the live "
        "metrics into an in-process timeline and evaluates the spec's "
        "multi-window burn-rate alert rules on every tick (alert open/close -> "
        "counters + flight records + sched.alert spans; GET /slo and GET "
        "/signals serve live status under --listen)",
    )
    p.add_argument(
        "--capacity-eps", type=float, default=None,
        help="max-sustainable events/sec from a capacity probe (`overload`): "
        "the /signals payload reports autoscaling headroom against it",
    )
    p.add_argument(
        "--compile-ledger", action="store_true",
        help="enable the process-wide compile ledger: every kernel-library "
        "load (an nvcc run or a build-cache hit) and every CUDA-graph capture "
        "is attributed to its entry point and classified (cold / cache-hit / "
        "static-arg-flip / shape-bucket-change / recompile), ticks that paid "
        "one say so on their span + flight record, and the summary grows a "
        "'compile' block (render it with `compiles`)",
    )
    p.add_argument(
        "--compile-ledger-out", default=None, metavar="FILE",
        help="dump the compile ledger as JSONL at exit (implies "
        "--compile-ledger); reload with `compiles --load`",
    )
    p.add_argument(
        "--compile-warm-events", type=int, default=2, metavar="N",
        help="handled events per fleet after which the ledgers' WARM-phase "
        "boundary is marked: the summary's compile.warm_phase_compiles counts "
        "compile events past it (default 2: the cold solve and the first warm "
        "tick each capture their own graph); with --memory-ledger the same "
        "boundary pins the leak-gate baseline (warm serving must stay FLAT in "
        "allocated bytes from there on)",
    )
    p.add_argument(
        "--memory-ledger", action="store_true",
        help="enable the process-wide memory ledger: every registered entry "
        "point gets a static memory model on its first dispatch (the CUDA "
        "allocator's peak and reserved deltas, argument and output bytes), "
        "every loop plan its owned bytes, ticks carry allocated/RSS watermark "
        "attrs, mem.* series ride the metrics timeline, GET /signals grows "
        "mem_headroom_bytes, and the summary grows a 'memory' block (render it "
        "with `memory`)",
    )
    p.add_argument(
        "--memory-out", default=None, metavar="FILE",
        help="dump the memory ledger as JSONL at exit (implies "
        "--memory-ledger); reload with `memory --load`",
    )
    p.add_argument(
        "--memory-budget-mb", type=float, default=None,
        help="memory-headroom budget in MB (default: /proc/meminfo MemTotal): "
        "mem_headroom_bytes in GET /signals = budget - RSS, and "
        "--mem-degrade-headroom-mb degrades against it",
    )
    p.add_argument(
        "--mem-degrade-headroom-mb", type=float, default=None, metavar="MB",
        help="gateway admission: when memory headroom (budget - RSS) drops "
        "below this many MB, ingest marks ticks under PRESSURE (composing with "
        "--degrade-depth); needs --memory-ledger",
    )
    _add_gateway_args(p)
    return p


def _add_gateway_args(p: argparse.ArgumentParser) -> None:
    """The gateway tier's options of ``serve`` (``distilp_torch.gateway``):
    any of them, or a fleet-tagged trace, serves through the gateway."""
    g = p.add_argument_group("gateway tier (many fleets over N solve workers)")
    g.add_argument(
        "--workers", type=int, default=1,
        help="solve workers; each (fleet, model) shard is owned by exactly one "
        "of them (consistent hashing) and ticks on its thread",
    )
    g.add_argument(
        "--worker-backend", choices=("thread", "process"), default="thread",
        help="host shard workers in threads (default) or dedicated subprocesses "
        "(own GIL, own CUDA context; they load the kernels the parent built)",
    )
    g.add_argument(
        "--scheduler-factory", default=None, metavar="MOD:FN",
        help="'module:callable' scheduler factory resolved in whichever process "
        "hosts the shard (tests.torch_procstub:make_scheduler is the solver-free "
        "stub the tests use)",
    )
    g.add_argument(
        "--supervise", action="store_true",
        help="supervise process workers: a crashed child is respawned with "
        "bounded backoff and its shards restored WARM from per-shard "
        "micro-snapshots + WAL-tail replay (exactly-once); needs "
        "--worker-backend process",
    )
    g.add_argument(
        "--recovery-dir", default=None, metavar="DIR",
        help="with --supervise: root directory of the per-fleet WALs and "
        "micro-snapshots (default: a private tempdir removed at close)",
    )
    g.add_argument(
        "--snapshot-every", type=int, default=8, metavar="N",
        help="with --supervise: micro-snapshot each shard every N handled events",
    )
    g.add_argument(
        "--listen", default=None, metavar="HOST:PORT",
        help="after the trace replay, keep serving the gateway's HTTP/1.1 JSON "
        "API (POST /events, GET /placement/<fleet>, /healthz, /metrics) until "
        "interrupted",
    )
    g.add_argument(
        "--max-queue-depth", type=int, default=None, metavar="N",
        help="bound each solve worker's queue at N commands; an event arriving "
        "at a full queue is shed (events_shed; HTTP 429 + Retry-After)",
    )
    g.add_argument(
        "--coalesce", action="store_true",
        help="fold drift events queued for the same shard into ONE solve at the "
        "newest state (structural events are barriers)",
    )
    g.add_argument(
        "--degrade-depth", type=int, default=None, metavar="N",
        help="queue depth at which a speculative shard may serve a banked "
        "near-match (mode='spec_near') instead of queueing the solve",
    )
    g.add_argument(
        "--snapshot-dir", default=None,
        help="directory of the gateway's warm-state snapshot (written by "
        "--snapshot-at, read by --resume)",
    )
    g.add_argument(
        "--snapshot-at", type=int, default=None, metavar="N",
        help="snapshot every shard after the N-th replayed event",
    )
    g.add_argument(
        "--halt-after-snapshot", action="store_true",
        help="stop the replay right after --snapshot-at (a planned restart)",
    )
    g.add_argument(
        "--resume", action="store_true",
        help="restore every shard from --snapshot-dir, then replay only the "
        "events its resume cursors do not cover",
    )


def _gateway_mode(args) -> bool:
    """Whether ``serve`` runs through the gateway tier."""
    if (args.workers > 1 or args.listen or args.snapshot_dir or args.resume
            or args.max_queue_depth is not None or args.coalesce
            or args.degrade_depth is not None or args.mem_degrade_headroom_mb is not None
            or args.worker_backend != "thread"
            or args.scheduler_factory is not None or args.supervise):
        return True
    if Path(args.trace).is_file():
        from ..gateway.traces import is_gateway_trace

        return is_gateway_trace(args.trace)
    return False


def _build_obs(args):
    """(tracer, writer, flight) from the serve observability flags; None
    everywhere when they are off, so the scheduler runs its uninstrumented
    default path."""
    tracer = writer = flight = None
    if args.trace_spans_dir:
        from ..obs import JsonlSpanWriter, Tracer

        writer = JsonlSpanWriter(Path(args.trace_spans_dir) / "spans.jsonl")
        tracer = Tracer(capacity=65536, writer=writer)
    if args.flight_dir:
        from ..obs import FlightRecorder

        flight = FlightRecorder(capacity=max(1, args.flight_capacity),
                                dump_dir=args.flight_dir)
    return tracer, writer, flight


def _obs_summary(writer, flight) -> dict:
    out = {}
    if writer is not None:
        out["spans_written"] = writer.written
        out["spans_path"] = str(writer.path)
    if flight is not None:
        out["flight_dumps"] = [str(p) for p in flight.dumps]
    return out


def _build_compile_ledger(args):
    """(ledger, owned) from the serve flags; (None, False) on the
    byte-identical default path (instrumented entry points stay
    passthroughs). ``owned`` means THIS run enabled the process ledger
    and must disable it on exit — a leaked global ledger would mint
    compile counters into every scheduler an in-process caller builds
    afterwards."""
    if not (args.compile_ledger or args.compile_ledger_out):
        return None, False
    from ..obs import compile_ledger

    existing = compile_ledger.current()
    if existing is not None:
        return existing, False
    return compile_ledger.enable(), True


def _release_compile_ledger(owned: bool) -> None:
    if owned:
        from ..obs import compile_ledger

        compile_ledger.disable()


def _compile_summary(args, led, warm_token) -> dict:
    """The serve summary's "compile" block (+ the JSONL dump side effect).

    ``warm_token`` is the ledger seq at the warm-phase boundary (every
    fleet past ``--compile-warm-events`` handled events) — compile events
    after it are warm-phase compiles, the count the zero-recapture gate
    reads; None when the replay ended before the boundary was reached.
    """
    from ..obs import compile_ledger

    warm = (
        len(led.events_since(warm_token)) if warm_token is not None else None
    )
    summary = led.summary()
    out = {
        "counters": summary["counters"],
        "cache_hit_rate": summary["cache_hit_rate"],
        "causes": summary["causes"],
        "entries": summary["entries"],
        "registered": compile_ledger.registered_entry_points(),
        "unregistered_compiles": summary["counters"]["unattributed_compiles"],
        "warm_boundary_marked": warm_token is not None,
        "warm_phase_compiles": warm,
        "fallback": summary["fallback"],
    }
    if args.compile_ledger_out:
        led.dump_jsonl(args.compile_ledger_out)
        out["ledger_path"] = str(args.compile_ledger_out)
    return out


def _build_memory_ledger(args):
    """(ledger, owned) from the serve memory flags; (None, False) on the
    byte-identical default path. Same ownership contract as the compile
    ledger: a serve-OWNED ledger is disable()d in the finally so
    in-process callers never inherit the process-global hook."""
    if not (args.memory_ledger or args.memory_out):
        return None, False
    from ..obs import memory

    existing = memory.current()
    if existing is not None:
        if args.memory_budget_mb is not None:
            # The explicit flag wins over whatever budget the reused
            # process ledger resolved.
            existing.budget_bytes = int(args.memory_budget_mb * 1e6)
        return existing, False
    kwargs = {}
    if args.memory_budget_mb is not None:
        kwargs["budget_bytes"] = int(args.memory_budget_mb * 1e6)
    return memory.enable(**kwargs), True


def _release_memory_ledger(owned: bool) -> None:
    if owned:
        from ..obs import memory

        memory.disable()


def _memory_summary(args, mled) -> dict:
    """The serve summary's "memory" block (+ the JSONL dump side effect):
    per-entry static models, watermarks, and the leak-gate verdict
    (marked at the --compile-warm-events boundary)."""
    # One forced sample first: the replay is drained here, and the leak
    # verdict must compare the baseline against the run's TRUE final
    # allocated bytes, not a stale cached sample.
    mled.sample(force=True)
    out = mled.summary()
    if args.memory_out:
        mled.dump_jsonl(args.memory_out)
        out["ledger_path"] = str(args.memory_out)
    return out


def _build_slo(args, metrics, sample_fn, tracer, flight):
    """(timeline, engine, sampler) from the serve SLO flags, all None
    when neither --slo nor --timeline-dir is set (the byte-identical
    default path). The sampler is returned STARTED; the caller stops it
    (or lets Gateway.close do so when it is attached there)."""
    if not (args.slo or args.timeline_dir):
        return None, None, None
    from ..obs import SLOConfig, SLOEngine, Timeline, TimelineSampler

    timeline = Timeline()
    engine = None
    if args.slo:
        config = SLOConfig.from_json(args.slo)
        engine = SLOEngine(
            config, timeline, metrics=metrics, tracer=tracer, flight=flight
        )
    sampler = TimelineSampler(
        timeline,
        sample_fn,
        period_s=max(0.001, args.timeline_period_ms / 1e3),
        metrics=metrics,
        on_sample=(
            None if engine is None
            else (lambda _tl, now: engine.evaluate(now))
        ),
    )
    sampler.start()
    return timeline, engine, sampler


def _slo_summary(args, timeline, engine, sampler) -> dict:
    """The serve summary's "slo" block (+ the timeline dump side effect)."""
    out: dict = {
        "samples": sampler.samples,
        "sample_errors": sampler.errors,
        "series": len(timeline.names()),
    }
    if engine is not None:
        out["alerts_open"] = len(engine.firing())
        out["events"] = list(engine.events)
    if args.timeline_dir:
        path = Path(args.timeline_dir) / "timeline.jsonl"
        timeline.dump(path)
        out["timeline_path"] = str(path)
    return out


def _chaos_to_replay_report(chaos, sched):
    """A ChaosReport as the ReplayReport the summary prints. Latency stats
    cover the TRACE events only: injected quarantine round-trips and
    recovery ticks would flatter the percentiles."""
    from ..sched import STRUCTURAL_KINDS, ReplayReport
    from ..sched.metrics import _quantile

    trace_recs = [r for r in chaos.records if r.source == "trace"]
    lat = [r.ms for r in trace_recs]
    srt = sorted(lat)
    uncert = sum(
        1 for r in trace_recs
        if r.kind in STRUCTURAL_KINDS and r.view.events_behind == 0
        and not r.view.result.certified
    )
    total_s = sum(r.ms for r in chaos.records) / 1e3
    return ReplayReport(
        views=chaos.views, latencies_ms=lat,
        events_per_sec=len(lat) / total_s if total_s > 0 else 0.0,
        p50_ms=_quantile(srt, 0.50), p99_ms=_quantile(srt, 0.99),
        structural_uncertified=uncert,
        failed_ticks=sched.metrics.counters.get("tick_failed", 0),
    )


def serve_main(argv=None) -> int:
    """``serve``: replay a churn trace through the scheduler daemon."""
    args = build_serve_parser().parse_args(argv)
    if args.mem_degrade_headroom_mb is not None and not (
            args.memory_ledger or args.memory_out):
        # Degrading on headroom nobody measures would silently never fire.
        print("error: --mem-degrade-headroom-mb needs --memory-ledger (headroom "
              "comes from the memory ledger's budget - RSS)", file=sys.stderr)
        return 2
    trace_path = Path(args.trace)
    if _gateway_mode(args):
        if args.profile_dir:
            # torch.profiler is process-global; two shard workers profiling
            # their first ticks at once would race it.
            print("error: --profile-dir needs the single-scheduler path (no "
                  "gateway flags, --workers 1, single-fleet trace)", file=sys.stderr)
            return 2
        return _serve_gateway(args)
    if args.snapshot_at is not None or args.halt_after_snapshot:
        print("error: --snapshot-at/--halt-after-snapshot need --snapshot-dir "
              "(the gateway path)", file=sys.stderr)
        return 2
    if args.chaos_check and not args.fault_plan:
        print("error: --chaos-check needs --fault-plan (the soak contract is "
              "defined over an injected fault schedule)", file=sys.stderr)
        return 2
    if (args.mesh_shards or 1) > 1:
        from ..parallel import force_virtual_devices

        force_virtual_devices(args.mesh_shards)

    from ..common import load_from_profile_folder, load_model_profile
    from ..sched import Scheduler, drift_warm_share, read_trace, replay
    from ..utils import make_synthetic_fleet

    folder = Path(args.profile)
    if not folder.is_dir():
        print(f"error: {folder} is not a directory", file=sys.stderr)
        return 2
    if args.synthetic_fleet > 0:
        model = load_model_profile(folder / "model_profile.json")
        devices = make_synthetic_fleet(args.synthetic_fleet, seed=args.fleet_seed)
    else:
        devices, model = load_from_profile_folder(folder)
    if not trace_path.is_file():
        print(f"error: trace {trace_path} not found", file=sys.stderr)
        return 2
    try:
        events = read_trace(trace_path)
    except (OSError, ValueError) as e:  # ValidationError is a ValueError
        print(f"error: cannot parse trace: {e}", file=sys.stderr)
        return 2
    if not events:
        print("error: trace is empty", file=sys.stderr)
        return 2

    plan = None
    if args.fault_plan:
        from ..sched import FaultPlan

        try:
            plan = FaultPlan.from_json(args.fault_plan)
        except (OSError, ValueError) as e:
            print(f"error: cannot load --fault-plan: {e}", file=sys.stderr)
            return 2
        if args.fault_seed is not None:
            plan = plan.model_copy(update={"seed": args.fault_seed})

    # The hardening knobs reach the scheduler (and the summary) only when
    # asked for: a plain replay keeps the reference's plain summary.
    hardened = (plan is not None or args.deadline_ms is not None or args.max_retries
                or args.breaker_threshold is not None)
    harden_kw = {}
    if args.deadline_ms is not None:
        harden_kw["solve_deadline_s"] = args.deadline_ms / 1e3
    if args.max_retries:
        harden_kw["max_retries"] = args.max_retries
    if args.breaker_threshold is not None:
        harden_kw["breaker_threshold"] = args.breaker_threshold

    tracer, writer, flight = _build_obs(args)
    sched = Scheduler(
        devices, model, diagnostics=args.solver_diagnostics, mip_gap=args.mip_gap,
        kv_bits=args.kv_bits, backend=args.backend,
        k_candidates=_k_candidates(args.k_candidates), warm_pool_size=args.warm_pool,
        cold_start=args.cold_start, lp_backend=args.lp_backend,
        pdhg_iters=args.pdhg_iters, pdhg_restart_tol=args.pdhg_restart_tol,
        mesh_shards=args.mesh_shards, pdhg_dtype=args.pdhg_dtype,
        risk_aware=args.risk_aware, risk_samples=args.risk_samples,
        risk_seed=args.risk_seed, speculative=args.speculate, spec_k=args.spec_k,
        spec_tolerance=args.spec_tolerance, tracer=tracer, flight=flight,
        profile_dir=args.profile_dir, device=args.device, **harden_kw,
    )

    def log_event(ev, view, ms):
        # The daemon's event log: one line per tick, streamed.
        if args.quiet:
            return
        r = view.result
        risk = ""
        if view.twin_p95_s is not None:
            star = "*" if view.risk_selected else ""
            risk = f" twin_p95={view.twin_p95_s:.4f}{star}"
        print(
            f"[{sched.fleet.seq:4d}] {ev.kind:<10s} "
            f"M={len(r.w):2d} mode={view.mode:<6s} "
            f"certified={str(r.certified):<5s} k={r.k:<3d} "
            f"obj={r.obj_value:.6f} {ms:8.1f} ms{risk}"
        )

    timeline, slo_engine, sampler = _build_slo(
        args, sched.metrics, sched.timeline_sample, tracer, flight
    )
    led, led_owned = _build_compile_ledger(args)
    mled, mled_owned = _build_memory_ledger(args)
    compile_state = {"handled": 0, "warm_token": None, "warm_marked": False}

    def on_event(ev, view, ms):
        log_event(ev, view, ms)
        if (led is None and mled is None) or compile_state["warm_marked"]:
            return
        compile_state["handled"] += 1
        if compile_state["handled"] >= args.compile_warm_events:
            # Warm boundary: everything this single fleet loads, captures
            # and persistently allocates, it does in its first
            # --compile-warm-events ticks; the same boundary marks the
            # compile ledger's warm phase and pins the memory ledger's
            # leak-gate baseline.
            compile_state["warm_marked"] = True
            if led is not None:
                compile_state["warm_token"] = led.seq()
            if mled is not None:
                mled.mark_warm()

    chaos = None
    try:
        if plan is not None:
            from ..sched import chaos_replay

            chaos = chaos_replay(sched, events, plan, on_event=on_event)
            report = _chaos_to_replay_report(chaos, sched)
        else:
            report = replay(sched, events, on_event=on_event)
    except (RuntimeError, ValueError) as e:
        print(f"error: replay failed: {e}", file=sys.stderr)
        return 1
    finally:
        if sampler is not None:
            sampler.stop()  # before close: no sampling a torn-down daemon
        sched.close()  # release the deadline worker (no-op when unused)
        if tracer is not None:
            tracer.close()  # flush the span JSONL
        _release_compile_ledger(led_owned)
        _release_memory_ledger(mled_owned)

    summary = {
        "replay": report.summary(),
        "drift_warm_share": round(drift_warm_share(sched.metrics), 4),
        "metrics": sched.metrics_snapshot(),
    }
    if hardened:
        summary["health"] = sched.health_snapshot()
    if chaos is not None:
        summary["chaos"] = chaos.summary()
        if flight is not None and chaos.violations(sched.fleet.model.L):
            # A violated soak is the post-mortem moment the flight recorder
            # exists for: dump before the process reports it.
            if flight.trigger("default", "chaos_violation") is not None:
                sched.metrics.inc("flight_dumps")
    if args.speculate:
        summary["speculation"] = sched.speculation_snapshot()
    if led is not None:
        summary["compile"] = _compile_summary(args, led, compile_state["warm_token"])
    if mled is not None:
        summary["memory"] = _memory_summary(args, mled)
    if sampler is not None:
        summary["slo"] = _slo_summary(args, timeline, slo_engine, sampler)
    if writer is not None or flight is not None:
        summary["obs"] = _obs_summary(writer, flight)
    if args.risk_aware:
        c = sched.metrics.counters
        summary["risk"] = {"evals": c["risk_eval"], "candidates": c["risk_candidates"],
                           "switches": c["risk_switch"], "errors": c["risk_error"]}
    print(json.dumps(summary))
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(summary, indent=2))
    if args.chaos_check:
        violations = chaos.violations(sched.fleet.model.L)
        if violations:
            for v in violations:
                print(f"chaos violation: {v}", file=sys.stderr)
            return 1
        print(
            f"chaos soak OK: {chaos.injected.get('injected_total', 0)} "
            f"fault(s) injected, {chaos.summary()['quarantined']} "
            f"quarantined, healthy after {chaos.ticks_to_healthy} clean tick(s)"
        )
    if args.fail_uncertified and (report.structural_uncertified or report.failed_ticks):
        print(
            f"error: {report.structural_uncertified} structural event(s) missed the "
            f"optimality certificate, {report.failed_ticks} tick(s) produced no "
            "placement at all",
            file=sys.stderr,
        )
        return 1
    return 0


def _serve_gateway(args) -> int:
    """``serve`` through the gateway tier (``distilp_torch.gateway``).

    Engaged by --workers > 1, --listen, --snapshot-dir/--resume, the
    admission and process-worker flags, or a fleet-tagged (multi-fleet)
    trace. The replay itself is SEQUENTIAL in trace order — this path is
    the correctness/operations surface (deterministic replays, snapshot
    cycles, chaos and crash soaks); concurrent throughput is the load
    generator's job (``gateway.loadgen``).
    """
    import time as _time

    from ..common import load_from_profile_folder, load_model_profile
    from ..gateway import (
        Gateway,
        ShardFacade,
        load_snapshot,
        read_gateway_trace,
        save_snapshot,
    )
    from ..gateway.traces import is_gateway_trace, make_fleet_from_spec
    from ..sched import STRUCTURAL_KINDS, drift_warm_share, read_trace
    from ..sched.metrics import _quantile
    from ..utils import make_synthetic_fleet

    folder = Path(args.profile)
    if not folder.is_dir():
        print(f"error: {folder} is not a directory", file=sys.stderr)
        return 2
    trace_path = Path(args.trace)
    if not trace_path.is_file():
        print(f"error: trace {trace_path} not found", file=sys.stderr)
        return 2
    if args.snapshot_at is not None and not args.snapshot_dir:
        print("error: --snapshot-at needs --snapshot-dir", file=sys.stderr)
        return 2
    if args.resume and not args.snapshot_dir:
        print("error: --resume needs --snapshot-dir", file=sys.stderr)
        return 2
    if args.chaos_check and not args.fault_plan:
        print("error: --chaos-check needs --fault-plan (the soak contract is "
              "defined over an injected fault schedule)", file=sys.stderr)
        return 2

    model = load_model_profile(folder / "model_profile.json")
    try:
        multi = is_gateway_trace(trace_path)
        if multi:
            specs, items = read_gateway_trace(trace_path)
        else:
            specs = {}
            items = [("default", ev) for ev in read_trace(trace_path)]
    except (OSError, ValueError) as e:
        print(f"error: cannot parse trace: {e}", file=sys.stderr)
        return 2
    if not items:
        print("error: trace is empty", file=sys.stderr)
        return 2

    plan = None
    if args.fault_plan:
        if multi:
            # The fault plan's tick schedule is defined over ONE fleet's
            # replay; spraying it across interleaved fleets would make the
            # soak contract unverifiable.
            print("error: --fault-plan needs a single-fleet trace",
                  file=sys.stderr)
            return 2
        if args.snapshot_at is not None or args.halt_after_snapshot:
            print("error: --fault-plan cannot combine with --snapshot-at/"
                  "--halt-after-snapshot (the chaos soak does not snapshot "
                  "mid-replay)", file=sys.stderr)
            return 2
        from ..sched import FaultPlan

        try:
            plan = FaultPlan.from_json(args.fault_plan)
        except (OSError, ValueError) as e:
            print(f"error: cannot load --fault-plan: {e}", file=sys.stderr)
            return 2
        if args.fault_seed is not None:
            plan = plan.model_copy(update={"seed": args.fault_seed})
    if args.supervise and args.worker_backend != "process":
        print("error: --supervise needs --worker-backend process (thread "
              "workers share the gateway's life; there is no child to "
              "respawn)", file=sys.stderr)
        return 2

    scheduler_kwargs = dict(
        mip_gap=args.mip_gap, kv_bits=args.kv_bits, backend=args.backend,
        diagnostics=args.solver_diagnostics,
        k_candidates=_k_candidates(args.k_candidates), warm_pool_size=args.warm_pool,
        cold_start=args.cold_start, lp_backend=args.lp_backend,
        pdhg_iters=args.pdhg_iters, pdhg_restart_tol=args.pdhg_restart_tol,
        mesh_shards=args.mesh_shards, pdhg_dtype=args.pdhg_dtype,
        risk_aware=args.risk_aware, risk_samples=args.risk_samples,
        risk_seed=args.risk_seed, speculative=args.speculate, spec_k=args.spec_k,
        spec_tolerance=args.spec_tolerance,
    )
    if args.deadline_ms is not None:
        scheduler_kwargs["solve_deadline_s"] = args.deadline_ms / 1e3
    if args.max_retries:
        scheduler_kwargs["max_retries"] = args.max_retries
    if args.breaker_threshold is not None:
        scheduler_kwargs["breaker_threshold"] = args.breaker_threshold
    # The HiGHS oracle needs no card: --backend cpu alone serves on the CPU.
    device = args.device
    if device is None and args.backend == "cpu":
        device = "cpu"

    tracer, writer, flight = _build_obs(args)
    try:
        gw = Gateway(
            n_workers=args.workers, scheduler_kwargs=scheduler_kwargs,
            scheduler_factory=args.scheduler_factory, tracer=tracer, flight=flight,
            max_queue_depth=args.max_queue_depth, coalesce=args.coalesce,
            degrade_depth=args.degrade_depth,
            mem_degrade_headroom_bytes=(
                args.mem_degrade_headroom_mb * 1e6
                if args.mem_degrade_headroom_mb is not None else None
            ),
            worker_backend=args.worker_backend,
            supervise=args.supervise, recovery_dir=args.recovery_dir,
            snapshot_every=args.snapshot_every, device=device,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    timeline, slo_engine, sampler = _build_slo(
        args, gw.metrics, gw.timeline_sample, tracer, flight
    )
    if sampler is not None:
        # Attached: Gateway.close() stops the sampler before the workers
        # and --listen keeps it (and /slo, /signals) live until ^C.
        gw.attach_sampler(sampler)
        gw.attach_slo(slo_engine, timeline, capacity_eps=args.capacity_eps)
    led, led_owned = _build_compile_ledger(args)
    mled, mled_owned = _build_memory_ledger(args)
    # Warm boundary for the ledgers: marked once EVERY fleet actually
    # REPLAYED this run has handled --compile-warm-events events (each
    # fleet's target is min(knob, its replayed-event count), filled in
    # from run_items below, after the resume cursor is applied). Compile
    # events past the mark are warm-phase compiles (the zero-recapture
    # invariant); allocated growth past it is a leak.
    compile_state = {
        "counts": {}, "targets": {}, "warm_token": None, "warm_marked": False,
    }

    def _note_handled_for_ledger(fleet_id: str) -> None:
        targets = compile_state["targets"]
        if (led is None and mled is None) or compile_state["warm_marked"] or not targets:
            return
        counts = compile_state["counts"]
        counts[fleet_id] = counts.get(fleet_id, 0) + 1
        if all(counts.get(f, 0) >= n for f, n in targets.items()):
            compile_state["warm_marked"] = True
            if led is not None:
                compile_state["warm_token"] = led.seq()
            if mled is not None:
                mled.mark_warm()

    try:
        if args.resume:
            try:
                snap = load_snapshot(args.snapshot_dir)
            except (OSError, ValueError) as e:
                print(f"error: cannot load snapshot: {e}", file=sys.stderr)
                return 2
            gw.load_snapshot(snap)
            for fleet_id in (list(specs) if multi else ["default"]):
                if fleet_id not in gw.fleet_ids():
                    print(f"error: trace fleet {fleet_id!r} is not in the snapshot; "
                          "resume needs the same trace", file=sys.stderr)
                    return 2
        elif multi:
            for fleet_id, spec in specs.items():
                gw.register_fleet(fleet_id, make_fleet_from_spec(fleet_id, spec), model)
        else:
            if args.synthetic_fleet > 0:
                devices = make_synthetic_fleet(args.synthetic_fleet, seed=args.fleet_seed)
            else:
                devices, model = load_from_profile_folder(folder)
            gw.register_fleet("default", devices, model)

        # Resume cursor: skip the per-fleet prefix the snapshot already
        # covers (Gateway.uncovered owns the contract).
        run_items = gw.uncovered(items)
        if led is not None or mled is not None:
            per_fleet: dict = {}
            for f, _ev in run_items:
                per_fleet[f] = per_fleet.get(f, 0) + 1
            compile_state["targets"] = {
                f: min(args.compile_warm_events, n) for f, n in per_fleet.items()
            }

        def log_event(fleet_id, ev, view, ms):
            if args.quiet:
                return
            r = view.result
            print(
                f"[{fleet_id} {view.fleet_seq:4d}] {ev.kind:<10s} "
                f"M={len(r.w):2d} mode={view.mode:<6s} "
                f"certified={str(r.certified):<5s} k={r.k:<3d} "
                f"obj={r.obj_value:.6f} {ms:8.1f} ms"
            )

        chaos = None
        snapshot_taken = False
        final_views = {}
        if plan is not None:
            from ..sched import chaos_replay

            facade = ShardFacade(gw, "default")

            def _chaos_on_event(ev, view, ms):
                log_event("default", ev, view, ms)
                _note_handled_for_ledger("default")

            chaos = chaos_replay(
                facade, [ev for _, ev in run_items], plan,
                on_event=_chaos_on_event,
                # Process-channel faults (child_kill / rpc_torn / rpc_delay)
                # aim at whichever worker currently owns the fleet's shard.
                process_hook=gw.chaos_process_hook("default") if args.supervise else None,
                recovery_probe=gw.recovery_status if args.supervise else None,
            )
            replay_summary = _chaos_to_replay_report(chaos, facade).summary()
            if chaos.views:
                final_views["default"] = chaos.views[-1]
        else:
            lat = []
            uncert = 0
            t_start = _time.perf_counter()
            for handled, (fleet_id, ev) in enumerate(run_items, 1):
                t0 = _time.perf_counter()
                view = gw.handle_event(fleet_id, ev)
                ms = (_time.perf_counter() - t0) * 1e3
                lat.append(ms)
                final_views[fleet_id] = view
                if (ev.kind in STRUCTURAL_KINDS and view.events_behind == 0
                        and not view.result.certified):
                    uncert += 1
                log_event(fleet_id, ev, view, ms)
                _note_handled_for_ledger(fleet_id)
                if args.snapshot_at is not None and handled == args.snapshot_at:
                    save_snapshot(gw.snapshot(), args.snapshot_dir)
                    snapshot_taken = True
                    if not args.quiet:
                        print(f"[snapshot] {len(gw.fleet_ids())} shard(s) -> "
                              f"{args.snapshot_dir} after {handled} event(s)")
                    if args.halt_after_snapshot:
                        break
            total_s = _time.perf_counter() - t_start
            srt = sorted(lat)
            replay_summary = {
                "events": len(lat),
                "events_per_sec": round(len(lat) / total_s, 2) if total_s > 0 else 0.0,
                "p50_ms": round(_quantile(srt, 0.50), 3),
                "p99_ms": round(_quantile(srt, 0.99), 3),
                "structural_uncertified": uncert,
            }

        mx = gw.metrics_snapshot()
        totals = mx["shard_totals"]
        replay_summary["failed_ticks"] = totals.get("tick_failed", 0)
        summary = {
            "replay": replay_summary,
            "gateway": {
                "workers": args.workers,
                "fleets": len(gw.fleet_ids()),
                "resumed": bool(args.resume),
                "snapshot_taken": snapshot_taken,
                "warm_resumes": totals.get("warm_resumes", 0),
                "cold_resumes": totals.get("cold_resumes", 0),
                "tick_cold": totals.get("tick_cold", 0),
                "tick_warm": totals.get("tick_warm", 0),
                "tick_margin": totals.get("tick_margin", 0),
                "events_quarantined": totals.get("events_quarantined", 0),
            },
            "final_placements": {
                f: {"k": v.result.k, "w": v.result.w, "n": v.result.n, "y": v.result.y,
                    "obj_value": v.result.obj_value, "certified": v.result.certified}
                for f, v in sorted(final_views.items())
            },
            "health": gw.healthz(),
            "metrics": mx,
        }
        if args.max_queue_depth is not None or args.coalesce or args.degrade_depth is not None:
            summary["gateway"]["events_shed"] = mx["counters"].get("events_shed", 0)
            summary["gateway"]["events_coalesced"] = totals.get("events_coalesced", 0)
            summary["gateway"]["spec_near_hits"] = totals.get("spec_near_hit", 0)
        if args.worker_backend == "process":
            # Each child: its start (spawn to first ping) per generation and
            # the nvcc runs it reported (0: it loaded the parent's kernels).
            summary["gateway"]["process_workers"] = [
                w.child_report() for w in gw.live_workers()
            ]
        if not multi:
            summary["drift_warm_share"] = round(
                drift_warm_share(ShardFacade(gw, "default").metrics), 4)
        if args.speculate:
            s_hits = totals.get("spec_hit", 0)
            s_probes = s_hits + totals.get("spec_miss", 0)
            summary["speculation"] = {
                "hits": s_hits, "misses": totals.get("spec_miss", 0),
                "presolved": totals.get("spec_presolve", 0),
                "presolve_failed": totals.get("spec_presolve_failed", 0),
                "stale": totals.get("spec_stale", 0),
                "hit_rate": round(s_hits / s_probes, 4) if s_probes else 0.0,
            }
        if led is not None:
            summary["compile"] = _compile_summary(args, led, compile_state["warm_token"])
        if mled is not None:
            summary["memory"] = _memory_summary(args, mled)
        chaos_L = None
        if chaos is not None:
            # Proxy-safe L read: on the process backend the shard scheduler
            # is a SchedulerProxy; the facade rebuilds the fleet view.
            fl = getattr(ShardFacade(gw, "default"), "fleet", None)
            chaos_L = getattr(getattr(fl, "model", None), "L", None)
            summary["chaos"] = chaos.summary()
            if flight is not None and chaos.violations(chaos_L):
                if flight.trigger("default", "chaos_violation") is not None:
                    gw.metrics.inc("flight_dumps")
        if args.supervise:
            # The supervision audit rides the report even without chaos.
            summary["recovery"] = gw.recovery_status()
        if sampler is not None:
            summary["slo"] = _slo_summary(args, timeline, slo_engine, sampler)
        if writer is not None or flight is not None:
            summary["obs"] = _obs_summary(writer, flight)
        print(json.dumps(summary))
        if args.metrics_out:
            Path(args.metrics_out).write_text(json.dumps(summary, indent=2))

        if args.worker_backend == "process" and not args.quiet:
            for rep in summary["gateway"]["process_workers"]:
                print(f"process worker {rep['worker']}: child start ms {rep['start_ms']}, "
                      f"nvcc runs by generation {rep['nvcc_runs']}")
        if args.chaos_check:
            violations = chaos.violations(chaos_L)
            if violations:
                for v in violations:
                    print(f"chaos violation: {v}", file=sys.stderr)
                return 1
            ok_line = (
                f"chaos soak OK ({args.workers} workers): "
                f"{chaos.injected.get('injected_total', 0)} fault(s) "
                f"injected, {chaos.summary()['quarantined']} quarantined, "
                f"healthy after {chaos.ticks_to_healthy} clean tick(s)"
            )
            if chaos.recovery is not None:
                rec = chaos.recovery
                ok_line += (
                    f"; crash contract OK: {rec.get('worker_crashes', 0)} "
                    f"crash(es), {rec.get('child_respawns', 0)} "
                    f"respawn(s), {rec.get('workers_quarantined', 0)} "
                    f"quarantined, events_lost={rec.get('events_lost', 0)}, "
                    f"replayed={rec.get('events_replayed', 0)}"
                )
            print(ok_line)
        if args.fail_uncertified and (replay_summary.get("structural_uncertified")
                                      or replay_summary["failed_ticks"]):
            print(
                f"error: {replay_summary.get('structural_uncertified', 0)} "
                "structural event(s) missed the optimality certificate, "
                f"{replay_summary['failed_ticks']} tick(s) produced no "
                "placement at all",
                file=sys.stderr,
            )
            return 1
        if args.listen:
            return _listen_forever(gw, args.listen, quiet=args.quiet)
        return 0
    finally:
        gw.close()
        if tracer is not None:
            tracer.close()  # flush the span JSONL
        _release_compile_ledger(led_owned)
        _release_memory_ledger(mled_owned)


def _listen_forever(gw, listen: str, quiet: bool = False) -> int:
    """Serve the gateway's HTTP API until interrupted (serve --listen)."""
    import asyncio

    from ..gateway import GatewayHTTPServer

    host, _, port_s = listen.rpartition(":")
    host = host or "127.0.0.1"
    try:
        port = int(port_s)
    except ValueError:
        print(f"error: --listen wants HOST:PORT (got {listen!r})", file=sys.stderr)
        return 2

    async def _run() -> None:
        server = GatewayHTTPServer(gw, host=host, port=port)
        await server.start()
        if not quiet:
            print(
                f"gateway listening on http://{host}:{server.port} "
                "(POST /events, GET /placement/<fleet>, /healthz, /metrics)",
                flush=True,
            )
        await server.serve_forever()

    try:
        asyncio.run(_run())
    except KeyboardInterrupt:
        pass
    return 0


# -- spans: span JSONL -> Chrome trace-event JSON -----------------------------


def build_spans_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.cli.solver_cli spans",
        description="convert a span JSONL (serve --trace-spans-dir) into Chrome "
        "trace-event JSON loadable in Perfetto (ui.perfetto.dev) or "
        "chrome://tracing: one track per thread, spans as complete events",
    )
    p.add_argument("input", help="span JSONL file, or the --trace-spans-dir "
                   "directory holding spans.jsonl")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="Chrome trace JSON output path (default: <input>.chrome.json)")
    p.add_argument("--top", type=int, default=3,
                   help="also print the N slowest spans (0 disables)")
    p.add_argument(
        "--stats", action="store_true",
        help="aggregate instead of convert: one row per span name (count, "
        "p50/p99/max duration, slowest with trace ids); skips the Chrome JSON "
        "unless --out is also given",
    )
    p.add_argument("--quiet", action="store_true", help="no summary output")
    return p


def spans_main(argv=None) -> int:
    """``spans``: span JSONL -> Chrome trace-event JSON (or ``--stats``)."""
    args = build_spans_parser().parse_args(argv)

    from ..obs import read_spans, span_stats, spans_to_chrome, top_spans

    src = Path(args.input)
    if src.is_dir():
        src = src / "spans.jsonl"
    if not src.is_file():
        print(f"error: no span JSONL at {src}", file=sys.stderr)
        return 2
    try:
        spans = read_spans(src)
    except (OSError, ValueError) as e:  # JSONDecodeError is a ValueError
        print(f"error: cannot parse {src}: {e}", file=sys.stderr)
        return 2
    if not spans:
        print(f"error: {src} holds no spans", file=sys.stderr)
        return 1
    if args.stats:
        rows = span_stats(spans, top=max(0, args.top))
        print(
            f"{'span':<22s} {'count':>6s} {'total ms':>10s} "
            f"{'p50 ms':>9s} {'p99 ms':>9s} {'max ms':>9s}  slowest (trace ids)"
        )
        for r in rows:
            slow = ", ".join(f"{s['dur_ms']:.2f}ms@{s['trace_id']}" for s in r["slowest"])
            print(
                f"{r['name']:<22s} {r['count']:>6d} {r['total_ms']:>10.3f} "
                f"{r['p50_ms']:>9.3f} {r['p99_ms']:>9.3f} "
                f"{r['max_ms']:>9.3f}  {slow}"
            )
        if not args.out:
            return 0
    chrome = spans_to_chrome(spans)
    out = Path(args.out) if args.out else src.with_suffix(".chrome.json")
    out.write_text(json.dumps(chrome))
    if not args.quiet:
        traces = len({s["trace_id"] for s in spans})
        print(
            f"wrote {out}: {len(chrome['traceEvents'])} trace events from "
            f"{len(spans)} spans across {traces} traces (load in "
            "ui.perfetto.dev or chrome://tracing)"
        )
        if args.top > 0:
            print(f"top {args.top} slowest spans:")
            for s in top_spans(spans, args.top):
                attrs = s.get("attrs") or {}
                extra = "".join(f" {k}={attrs[k]}" for k in
                                ("fleet", "kind", "mode", "lp_backend") if k in attrs)
                print(f"  {s['dur_ms']:10.3f} ms  {s['name']:<20s} "
                      f"thread={s.get('thread', '?')}{extra}")
    return 0


def build_overload_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.cli.solver_cli overload",
        description="replay an open-loop arrival schedule against the "
        "gateway (events fire at their scheduled time — lateness "
        "accumulates, the generator never throttles) and report "
        "scheduled-time latency, sheds, coalesces and goodput; see "
        "distilp_torch.traffic",
    )
    p.add_argument(
        "--trace",
        required=True,
        help="open-loop JSONL schedule (fleet-tagged, timestamped; "
        "tests/traces/openloop_*.jsonl are committed seeded captures, "
        "traffic.generate_openloop_schedule makes new ones)",
    )
    p.add_argument(
        "--profile", "-p", required=True,
        help="profile folder; model_profile.json is the served model",
    )
    p.add_argument("--workers", type=int, default=2)
    p.add_argument(
        "--time-scale",
        type=float,
        default=1.0,
        help="compress (<1) or dilate (>1) the schedule's timeline: the "
        "same committed capture replays in real time or as a saturating "
        "flood, deterministically",
    )
    p.add_argument("--k-candidates", default=None)
    p.add_argument("--mip-gap", type=float, default=1e-3)
    p.add_argument("--kv-bits", default="4bit")
    p.add_argument("--warmup", type=int, default=2,
                   help="closed-loop warmup events per fleet (cold solve "
                   "+ graph capture, excluded from the open-loop phase)")
    _add_device(p)
    p.add_argument(
        "--max-queue-depth", type=int, default=None, metavar="N",
        help="admission gate: shed events arriving at a queue holding N",
    )
    p.add_argument(
        "--coalesce", action="store_true",
        help="fold same-shard queued drift events into one solve",
    )
    p.add_argument(
        "--combine", action="store_true",
        help="batch pending ticks ACROSS shards into padded lane batches "
        "behind the coalescer (one solve_batch search per bucket flush); "
        "enables the compile ledger so the zero-recapture gate is auditable",
    )
    p.add_argument(
        "--degrade-depth", type=int, default=None, metavar="N",
        help="queue depth past which speculative shards may serve a "
        "banked near-match (mode='spec_near'); pair with --speculate",
    )
    p.add_argument(
        "--speculate", action="store_true",
        help="enable speculative replanning on every shard (the bank "
        "degraded-mode serving draws from)",
    )
    p.add_argument(
        "--check",
        action="store_true",
        help="exit 1 unless the admission contract holds: every shed "
        "counted AND flight-recorded with reconciling per-fleet indices, "
        "every served placement structurally valid, no failed ticks",
    )
    p.add_argument(
        "--expect-sheds", action="store_true",
        help="with --check: additionally fail if NOTHING was shed (the "
        "smoke must actually overload the gate it is testing)",
    )
    p.add_argument(
        "--expect-coalesced", action="store_true",
        help="with --check: additionally fail if nothing was coalesced",
    )
    p.add_argument(
        "--expect-no-sheds", action="store_true",
        help="with --check: additionally fail if ANYTHING was shed (the "
        "coalesce smoke's contract: the flood folds instead of shedding)",
    )
    p.add_argument(
        "--expect-combined", action="store_true",
        help="with --check and --combine: fail unless combined batches "
        "actually served lanes, nothing fell back to a per-shard solve, "
        "and the measured phase compiled NOTHING (warm_phase_events == 0 "
        "— the committed-bucket zero-recompile contract)",
    )
    p.add_argument(
        "--slo", default=None, metavar="SPEC.json",
        help="attach the SLO engine to the flood: a timeline sampler "
        "runs for the arm's whole life, the executor feeds per-event "
        "scheduled-time latency, and burn-rate alerts open/close live "
        "(counters + flight records; report grows an 'slo' block)",
    )
    p.add_argument(
        "--settle-s", type=float, default=0.0,
        help="keep sampling this long AFTER the schedule drains — the "
        "recovery window a fired burn-rate alert needs to clear",
    )
    p.add_argument(
        "--timeline-out", default=None, metavar="FILE",
        help="dump the sampled timeline JSONL here (replay offline with "
        "`slo --timeline`)",
    )
    p.add_argument(
        "--expect-alert", action="append", default=None, metavar="SEV",
        help="with --check: fail unless an alert of this severity "
        "OPENED during the flood and CLOSED by the end of --settle-s, "
        "with the open/close counters reconciling record-by-record "
        "against the flight recorder's slo ring (repeatable)",
    )
    p.add_argument(
        "--worker-backend", choices=("thread", "process"), default="thread",
        help="host shard workers in threads (default) or dedicated "
        "subprocesses (own GIL, own CUDA context)",
    )
    p.add_argument(
        "--scheduler-factory", default=None, metavar="MOD:FN",
        help="'module:callable' scheduler factory resolved in whichever "
        "process hosts the shard — the only factory form that crosses a "
        "process boundary (tests.torch_procstub:make_scheduler is the "
        "solver-free stub the smokes use)",
    )
    p.add_argument(
        "--autoscale", default=None, metavar="POLICY.json",
        help="close the loop: build the gateway dynamic and run a "
        "ControlLoop under this policy for the flood's whole life — "
        "spawning/retiring workers with live warm shard migration, "
        "flipping degrade admission; report grows a 'control' block "
        "with the action trail + flight reconciliation",
    )
    p.add_argument(
        "--control-period-s", type=float, default=0.1,
        help="control loop decision period (seconds)",
    )
    p.add_argument(
        "--capacity-probe", type=int, default=0, metavar="N",
        help="with --autoscale: closed-loop probe of N events/fleet "
        "post-warmup to auto-populate the /signals headroom denominator "
        "(refreshed per worker-count change; 0 skips the probe)",
    )
    p.add_argument(
        "--expect-scale", type=int, default=None, metavar="N",
        help="with --check and --autoscale: fail unless the controller "
        "scaled the fleet out to at least N workers during the flood "
        "(and the control accounting reconciled record-by-record)",
    )
    p.add_argument("--metrics-out", default=None,
                   help="write the report JSON here too")
    p.add_argument("--quiet", action="store_true", help="summary line only")
    return p


def overload_main(argv=None) -> int:
    """``overload``: open-loop schedule -> gateway, admission on."""
    args = build_overload_parser().parse_args(argv)

    from ..common import load_model_profile
    from ..obs import FlightRecorder
    from ..traffic import read_openloop_trace, run_openloop

    folder = Path(args.profile)
    model_path = (
        folder / "model_profile.json" if folder.is_dir() else folder
    )
    if not model_path.is_file():
        print(f"error: no model profile at {model_path}", file=sys.stderr)
        return 2
    model = load_model_profile(model_path)
    try:
        specs, items = read_openloop_trace(args.trace)
    except (OSError, ValueError) as e:
        print(f"error: cannot parse open-loop trace: {e}", file=sys.stderr)
        return 2
    if not items:
        print("error: schedule has no events", file=sys.stderr)
        return 2
    k_candidates = None
    if args.k_candidates:
        k_candidates = [
            int(x) for x in args.k_candidates.split(",") if x.strip()
        ]
    slo_config = None
    if args.slo:
        from ..obs import SLOConfig

        try:
            slo_config = SLOConfig.from_json(args.slo)
        except (OSError, ValueError) as e:
            print(f"error: cannot load --slo spec: {e}", file=sys.stderr)
            return 2
    autoscale = None
    if args.autoscale:
        from ..control import ControlPolicy

        try:
            autoscale = ControlPolicy.from_json(args.autoscale)
        except (OSError, ValueError) as e:
            print(f"error: cannot load --autoscale: {e}", file=sys.stderr)
            return 2
    timeline = None
    if args.slo or args.timeline_out or args.autoscale:
        from ..obs import Timeline

        timeline = Timeline()
    led_owned = False
    if args.combine:
        # The zero-recapture gate needs the ambient ledger: run_openloop
        # reads warm-phase compile events off compile_ledger.current().
        from ..obs import compile_ledger as _compile_ledger

        if _compile_ledger.current() is None:
            _compile_ledger.enable()
            led_owned = True
    # A recorder is always attached here: the --check reconciliation is
    # the point of the command, and sheds must be observable to audit.
    flight = FlightRecorder(capacity=max(256, 2 * len(items)))
    try:
        report = run_openloop(
            model,
            specs,
            items,
            args.workers,
            device=args.device,
            time_scale=args.time_scale,
            warmup_per_fleet=args.warmup,
            k_candidates=k_candidates,
            mip_gap=args.mip_gap,
            kv_bits=args.kv_bits,
            scheduler_kwargs=(
                {"speculative": True} if args.speculate else None
            ),
            max_queue_depth=args.max_queue_depth,
            coalesce=args.coalesce,
            combine=args.combine,
            degrade_depth=args.degrade_depth,
            flight=flight,
            slo_config=slo_config,
            timeline=timeline,
            settle_s=args.settle_s,
            worker_backend=args.worker_backend,
            scheduler_factory=args.scheduler_factory,
            autoscale=autoscale,
            control_period_s=args.control_period_s,
            capacity_probe_events=args.capacity_probe,
        )
    finally:
        _release_compile_ledger(led_owned)
    if args.timeline_out and timeline is not None:
        timeline.dump(args.timeline_out)
        report["timeline_path"] = args.timeline_out
    print(json.dumps(report))
    if args.metrics_out:
        Path(args.metrics_out).write_text(json.dumps(report, indent=2))
    if not args.quiet:
        print(
            f"open-loop: {report['offered']} offered @ "
            f"{report['offered_eps']} ev/s -> {report['served']} served "
            f"({report['goodput_eps']} ev/s goodput), "
            f"{report['shed']} shed, {report['events_coalesced']} "
            f"coalesced, p99 {report['p99_ms']} ms / p99.9 "
            f"{report['p999_ms']} ms",
            file=sys.stderr,
        )
    if args.check:
        problems = list(report.get("shed_violations", []))
        if report["shed"] != report["events_shed"]:
            problems.append(
                f"shed accounting: executor saw {report['shed']} "
                f"QueueFull raises but events_shed={report['events_shed']}"
            )
        if report["invalid"]:
            problems.append(
                f"{report['invalid']} served placement(s) structurally "
                "invalid"
            )
        if report["failed"]:
            problems.append(f"{report['failed']} tick(s) failed under load")
        if args.expect_sheds and report["shed"] == 0:
            problems.append(
                "expected sheds but nothing was shed (the smoke did not "
                "overload the admission gate)"
            )
        if args.expect_coalesced and report["events_coalesced"] == 0:
            problems.append("expected coalescing but nothing was folded")
        if args.expect_no_sheds and report["shed"]:
            problems.append(
                f"expected zero sheds but {report['shed']} event(s) were "
                "shed (the flood should have folded, not overflowed)"
            )
        if args.expect_combined:
            comb = report.get("combine") or {}
            if not comb.get("instances"):
                problems.append(
                    "expected combined batches but no lane was ever "
                    "solved in one"
                )
            if comb.get("combine_fallback"):
                problems.append(
                    f"{comb['combine_fallback']} combined tick(s) fell "
                    "back to a per-shard solve"
                )
            if comb.get("errors"):
                problems.append(
                    f"{comb['errors']} batched dispatch(es) raised"
                )
            warm_events = (report.get("compile") or {}).get(
                "warm_phase_events"
            )
            if warm_events is None:
                problems.append(
                    "no warm-phase compile accounting in the report "
                    "(compile ledger not enabled?)"
                )
            elif warm_events:
                problems.append(
                    f"{warm_events} compile event(s) in the measured "
                    "phase — the committed bucket policy must make "
                    "combined traffic compile NOTHING after warm_combine "
                    f"(entries: {report['compile']['warm_phase_entries']})"
                )
        if autoscale is not None:
            ctl = report.get("control") or {}
            problems.extend(ctl.get("violations", []))
            if args.expect_scale is not None:
                peak = max(
                    (
                        a["target_workers"]
                        for a in ctl.get("actions", [])
                        if a.get("kind") == "scale_out"
                    ),
                    default=args.workers,
                )
                if peak < args.expect_scale:
                    problems.append(
                        f"expected the controller to scale out to >= "
                        f"{args.expect_scale} workers but it peaked at "
                        f"{peak}"
                    )
        if args.expect_alert:
            slo_rep = report.get("slo") or {}
            events = slo_rep.get("events", [])
            # Record-by-record reconciliation, shed-contract style: the
            # engine's transition list, the counters and the flight
            # recorder's slo ring must all tell the same story.
            flight_alerts = [
                r for r in flight.snapshot("slo")
                if r.get("kind") == "slo_alert"
            ]
            if len(flight_alerts) != len(events):
                problems.append(
                    f"alert accounting: {len(events)} engine transition(s) "
                    f"but {len(flight_alerts)} flight record(s)"
                )
            opened = sum(1 for e in events if e["state"] == "open")
            closed = sum(1 for e in events if e["state"] == "close")
            if opened != slo_rep.get("alerts_opened") or closed != slo_rep.get(
                "alerts_closed"
            ):
                problems.append(
                    f"alert accounting: events say {opened} open/{closed} "
                    f"close but counters say "
                    f"{slo_rep.get('alerts_opened')}/"
                    f"{slo_rep.get('alerts_closed')}"
                )
            for sev in args.expect_alert:
                sev_open = [
                    e for e in events
                    if e["severity"] == sev and e["state"] == "open"
                ]
                sev_close = [
                    e for e in events
                    if e["severity"] == sev and e["state"] == "close"
                ]
                if not sev_open:
                    problems.append(
                        f"expected a {sev!r} alert to open during the "
                        "flood but none did"
                    )
                elif len(sev_close) < len(sev_open):
                    problems.append(
                        f"{sev!r} alert opened but never closed (recovery "
                        "window too short, or the burn never cleared)"
                    )
        if problems:
            for pmsg in problems:
                print(f"overload violation: {pmsg}", file=sys.stderr)
            return 1
        print(
            f"overload OK: {report['shed']} shed (reconciled record-by-"
            f"record), {report['events_coalesced']} coalesced, "
            f"{report['served']} served valid", file=sys.stderr,
        )
    return 0


def build_slo_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.cli.solver_cli slo",
        description="evaluate SLOs: replay a dumped metrics timeline "
        "(serve --timeline-dir / overload --timeline-out) against a "
        "spec file offline — a pure function of (timeline, spec), "
        "byte-deterministic — or fetch a live gateway's /slo status, "
        "or trend-check the committed bench history",
    )
    p.add_argument(
        "--spec", default=None, metavar="SPEC.json",
        help="SLO spec file (obs.slo.SLOConfig JSON); required with "
        "--timeline",
    )
    p.add_argument(
        "--timeline", default=None, metavar="FILE",
        help="dumped timeline JSONL to replay the alert evaluation over "
        "(offline, deterministic)",
    )
    p.add_argument(
        "--url", default=None, metavar="http://HOST:PORT",
        help="fetch a live gateway's GET /slo instead (serve --listen "
        "--slo)",
    )
    p.add_argument(
        "--step-s", type=float, default=0.05,
        help="offline replay evaluation step (seconds of timeline time)",
    )
    p.add_argument(
        "--expect", default=None, metavar="FILE",
        help="expected alert sequence JSON ({bucket_s, events: [{slo, "
        "severity, state, bucket}]}): the replayed transitions must "
        "match EXACTLY — tier, window set, state and firing-timestamp "
        "bucket (exit 1 on any difference)",
    )
    p.add_argument(
        "--history", default=None, metavar="BENCH_HISTORY.jsonl",
        help="evaluate trend rules over a bench history JSONL (one line "
        "per round): the newest round's headline keys may not regress "
        "past the prior-median tolerance",
    )
    p.add_argument(
        "--check", action="store_true",
        help="exit 1 on any violation: --expect mismatch, alert-counter "
        "vs transition-list drift, or a --history trend regression",
    )
    p.add_argument(
        "--json", action="store_true",
        help="print the evaluation as one JSON object instead of tables",
    )
    p.add_argument("--quiet", action="store_true", help="no tables")
    return p


def _slo_render_tables(status: dict, events: list) -> None:
    print(f"{'slo':<28s} {'sev':<6s} {'window':>9s} {'burn':>10s} "
          f"{'threshold':>9s} {'firing':>6s}")
    for slo in status.get("slos", []):
        for rule in slo.get("alerts", []):
            for w in rule.get("windows", []):
                burn = w.get("burn")
                print(
                    f"{slo['name']:<28s} {rule['severity']:<6s} "
                    f"{w['window_s']:>8.6g}s "
                    f"{'-' if burn is None else format(burn, '>10.3f')} "
                    f"{w['threshold']:>9.3g} "
                    f"{str(rule['firing']):>6s}"
                )
    if events:
        print(f"\n{'t':>10s} {'slo':<28s} {'sev':<6s} {'state':<6s} burn")
        for e in events:
            print(
                f"{e['t']:>10.3f} {e['slo']:<28s} {e['severity']:<6s} "
                f"{e['state']:<6s} {e['burn']}"
            )
    else:
        print("\nno alert transitions")


def slo_main(argv=None) -> int:
    """``slo``: offline timeline replay / live status / trends."""
    args = build_slo_parser().parse_args(argv)

    # Pure JSON-in, JSON-out: no profiles, no device.
    violations: list = []
    payload: dict = {}

    if args.url:
        import urllib.request

        url = args.url.rstrip("/") + "/slo"
        try:
            with urllib.request.urlopen(url, timeout=10) as resp:
                status = json.loads(resp.read())
        except OSError as e:
            print(f"error: cannot fetch {url}: {e}", file=sys.stderr)
            return 2
        payload["live"] = status
        if not args.quiet and not args.json:
            _slo_render_tables(status, status.get("events", []))
        if status.get("alerts_open"):
            violations.append(
                f"{status['alerts_open']} alert(s) currently open on "
                f"{url}"
            )

    if args.timeline:
        if not args.spec:
            print("error: --timeline needs --spec", file=sys.stderr)
            return 2
        from ..obs import FlightRecorder, SLOConfig, SLOEngine, Timeline
        from ..sched.metrics import SchedulerMetrics

        try:
            config = SLOConfig.from_json(args.spec)
            timeline = Timeline.load(args.timeline)
        except (OSError, ValueError) as e:
            print(f"error: cannot load inputs: {e}", file=sys.stderr)
            return 2
        # The offline engine gets its own sink + flight ring so the
        # counter/record/transition reconciliation (the live contract)
        # is checkable on a replay too.
        metrics = SchedulerMetrics()
        flight = FlightRecorder(capacity=4096)
        engine = SLOEngine(config, timeline, metrics=metrics, flight=flight)
        events = engine.replay(step_s=args.step_s)
        status = engine.status()
        payload["replay"] = {
            "events": events,
            "alerts_open": status["alerts_open"],
            "step_s": args.step_s,
        }
        counters = metrics.snapshot()["counters"]
        opened = sum(1 for e in events if e["state"] == "open")
        closed = sum(1 for e in events if e["state"] == "close")
        if counters.get("slo_alert_opened", 0) != opened or counters.get(
            "slo_alert_closed", 0
        ) != closed:
            violations.append(
                "alert accounting: transitions "
                f"({opened} open/{closed} close) disagree with counters "
                f"({counters.get('slo_alert_opened', 0)}/"
                f"{counters.get('slo_alert_closed', 0)})"
            )
        flight_alerts = [
            r for r in flight.snapshot("slo") if r.get("kind") == "slo_alert"
        ]
        if len(flight_alerts) != len(events):
            violations.append(
                f"alert accounting: {len(events)} transition(s) but "
                f"{len(flight_alerts)} flight record(s)"
            )
        if args.expect:
            try:
                expect = json.loads(Path(args.expect).read_text())
            except (OSError, ValueError) as e:
                print(f"error: cannot load --expect: {e}", file=sys.stderr)
                return 2
            bucket_s = float(expect.get("bucket_s", 1.0))
            bounds = timeline.bounds()
            t0 = bounds[0] if bounds else 0.0
            got = [
                {
                    "slo": e["slo"],
                    "severity": e["severity"],
                    "state": e["state"],
                    "bucket": int((e["t"] - t0) / bucket_s),
                }
                for e in events
            ]
            if got != expect.get("events"):
                violations.append(
                    "alert sequence mismatch:\n  expected "
                    f"{json.dumps(expect.get('events'))}\n  got      "
                    f"{json.dumps(got)}"
                )
            payload["replay"]["expected_match"] = got == expect.get("events")
        if not args.quiet and not args.json:
            _slo_render_tables(status, events)

    if args.history:
        from ..obs.slo import evaluate_history

        try:
            rows = [
                json.loads(ln)
                for ln in Path(args.history).read_text().splitlines()
                if ln.strip()
            ]
        except (OSError, ValueError) as e:
            print(f"error: cannot load --history: {e}", file=sys.stderr)
            return 2
        table, trend_violations = evaluate_history(rows)
        payload["history"] = {"rows": len(rows), "table": table}
        violations.extend(trend_violations)
        if not args.quiet and not args.json:
            print(
                f"\nbench history ({len(rows)} round(s)): "
                f"{'key':<36s} {'median':>12s} {'latest':>12s} {'delta':>8s}"
            )
            for row in table:
                med = row["median"]
                lat = row["latest"]
                chg = row["change"]
                print(
                    f"{'':41s}{row['key']:<36s} "
                    f"{'-' if med is None else format(med, '>12.4g')} "
                    f"{'-' if lat is None else format(lat, '>12.4g')} "
                    f"{'-' if chg is None else format(chg, '>+8.1%')}"
                )

    if not (args.url or args.timeline or args.history):
        print(
            "error: nothing to evaluate (need --timeline, --url or "
            "--history)",
            file=sys.stderr,
        )
        return 2

    if args.json:
        payload["violations"] = violations
        print(json.dumps(payload))
    if violations:
        for v in violations:
            print(f"slo violation: {v}", file=sys.stderr)
        if args.check:
            return 1
    elif args.check and not args.quiet:
        print("slo check OK", file=sys.stderr)
    return 0


def build_autoscale_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.cli.solver_cli autoscale",
        description="replay a dumped metrics timeline through the "
        "closed-loop controller OFFLINE: a pure function of (timeline, "
        "policy, slo spec, step) — same inputs, same action sequence, "
        "byte for byte; the proof that the live loop's decisions are "
        "reproducible from its recorded signals",
    )
    p.add_argument(
        "--timeline", required=True, metavar="FILE",
        help="dumped timeline JSONL (serve --timeline-dir / overload "
        "--timeline-out)",
    )
    p.add_argument(
        "--policy", required=True, metavar="POLICY.json",
        help="control policy file (control.ControlPolicy JSON; "
        "tests/traces/control_policy.json is the committed smoke fixture)",
    )
    p.add_argument(
        "--spec", default=None, metavar="SLO.json",
        help="SLO spec evaluated alongside the replay so page/warn "
        "alerts feed the policy's alert-driven levers (omitting it "
        "leaves alerts_open at 0 for every step)",
    )
    p.add_argument(
        "--step-s", type=float, default=0.5,
        help="replay decision step (seconds of timeline time)",
    )
    p.add_argument(
        "--capacity-eps", type=float, default=None,
        help="max-sustainable events/sec pin for the headroom signal "
        "(the live loop measures this with a closed-loop probe; offline "
        "it must be pinned or the headroom levers stay dark)",
    )
    p.add_argument(
        "--workers", type=int, default=None,
        help="starting worker count (default: inferred from the "
        "timeline's queue_depth.w* series)",
    )
    p.add_argument(
        "--expect", default=None, metavar="FILE",
        help="expected action JSONL (actions_to_jsonl format, one "
        "key-sorted object per line): the replayed sequence must match "
        "BYTE FOR BYTE",
    )
    p.add_argument(
        "--out", default=None, metavar="FILE",
        help="write the replayed action JSONL here (the fixture "
        "regeneration path)",
    )
    p.add_argument(
        "--check", action="store_true",
        help="exit 1 on any violation: --expect mismatch, or a "
        "determinism failure (the replay runs TWICE from fresh "
        "controllers; the two byte streams must be identical)",
    )
    p.add_argument(
        "--json", action="store_true",
        help="print the evaluation as one JSON object instead of a table",
    )
    p.add_argument("--quiet", action="store_true", help="no table")
    return p


def autoscale_main(argv=None) -> int:
    """``autoscale``: offline controller replay, byte-deterministic."""
    args = build_autoscale_parser().parse_args(argv)

    # Pure JSON-in, JSON-out: no profiles, no device.
    from ..control import Controller, ControlPolicy, actions_to_jsonl
    from ..obs import Timeline

    try:
        timeline = Timeline.load(args.timeline)
        policy = ControlPolicy.from_json(args.policy)
    except (OSError, ValueError) as e:
        print(f"error: cannot load inputs: {e}", file=sys.stderr)
        return 2
    slo_config = None
    if args.spec:
        from ..obs import SLOConfig

        try:
            slo_config = SLOConfig.from_json(args.spec)
        except (OSError, ValueError) as e:
            print(f"error: cannot load --spec: {e}", file=sys.stderr)
            return 2

    def _run() -> str:
        return actions_to_jsonl(
            Controller.replay(
                timeline,
                policy,
                slo_config=slo_config,
                step_s=args.step_s,
                capacity_eps=args.capacity_eps,
                n_workers=args.workers,
            )
        )

    violations: list = []
    got = _run()
    if args.check and _run() != got:
        # A pure function cannot disagree with itself: any drift means a
        # clock or ambient-state leak into the decision path.
        violations.append(
            "determinism: two replays of the same (timeline, policy) "
            "produced different action streams"
        )
    if args.expect:
        try:
            expect = Path(args.expect).read_text()
        except OSError as e:
            print(f"error: cannot load --expect: {e}", file=sys.stderr)
            return 2
        if got != expect:
            violations.append(
                "action sequence mismatch:\n  expected "
                f"{expect!r}\n  got      {got!r}"
            )
    if args.out:
        Path(args.out).write_text(got)
    actions = [json.loads(ln) for ln in got.splitlines()]
    if args.json:
        print(json.dumps({
            "actions": actions,
            "step_s": args.step_s,
            "policy": policy.model_dump(),
            "violations": violations,
        }))
    elif not args.quiet:
        if actions:
            print(f"{'t':>10s} {'action':<12s} {'workers':>7s} reason")
            for a in actions:
                tw = a.get("target_workers")
                print(
                    f"{a['t']:>10.3f} {a['kind']:<12s} "
                    f"{'-' if tw is None else tw:>7} {a['reason']}"
                )
        else:
            print("no actions")
    if violations:
        for v in violations:
            print(f"autoscale violation: {v}", file=sys.stderr)
        if args.check:
            return 1
    elif args.check and not args.quiet:
        print(
            f"autoscale check OK: {len(actions)} action(s), "
            "byte-deterministic", file=sys.stderr,
        )
    return 0


def build_compiles_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.cli.solver_cli compiles",
        description="render the compile ledger (obs.compile_ledger: kernel-"
        "library loads and CUDA-graph captures): per-entry-point compile/"
        "dispatch table, cause histogram (cold / cache-hit / static-arg-flip "
        "/ shape-bucket-change / recompile), build-cache hit rate and the top "
        "recompile offenders — from a live run (--trace, replayed through "
        "`serve` with the "
        "ledger on) or a dumped JSONL (--load). Rendering a dump is a "
        "pure function: the same dump produces byte-identical reports on "
        "every replay",
    )
    p.add_argument(
        "--load", default=None, metavar="FILE",
        help="render a ledger JSONL previously dumped by "
        "`serve --compile-ledger-out` (or --out below); no backend needed",
    )
    p.add_argument(
        "--trace", default=None,
        help="live mode: replay this churn trace (single- or multi-fleet) "
        "with the ledger enabled and render the resulting ledger",
    )
    p.add_argument(
        "--profile", "-p", default=None,
        help="profile folder (required with --trace)",
    )
    p.add_argument("--synthetic-fleet", type=int, default=0, metavar="M")
    p.add_argument("--fleet-seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--mip-gap", type=float, default=1e-3)
    p.add_argument("--k-candidates", default=None)
    p.add_argument(
        "--lp-backend", choices=["ipm", "pdhg", "auto"], default="auto",
        help="LP engine pin for the live replay (the engine's route is part "
        "of a captured plan's static signature)",
    )
    p.add_argument(
        "--compile-warm-events", type=int, default=2, metavar="N",
        help="warm-boundary events per fleet for the live replay (see "
        "`serve --compile-warm-events`)",
    )
    p.add_argument(
        "--out", default=None, metavar="FILE",
        help="also save the live run's ledger JSONL here",
    )
    _add_device(p)
    p.add_argument("--top", type=int, default=5, help="top-N offenders/storms")
    p.add_argument(
        "--json", action="store_true",
        help="print the ledger summary as one JSON object instead of text",
    )
    p.add_argument(
        "--check", action="store_true",
        help="exit 1 unless the ledger is clean: every compile attributed "
        "to a REGISTERED entry point, no exact-signature recompiles, and "
        "the JSONL round-trips byte-stably (the smoke-compile contract)",
    )
    return p


def compiles_main(argv=None) -> int:
    """``compiles``: render/check the compile ledger."""
    args = build_compiles_parser().parse_args(argv)

    from ..obs.compile_ledger import (
        ledger_from_jsonl,
        ledger_to_jsonl,
        render_report,
    )

    if bool(args.load) == bool(args.trace):
        print(
            "error: exactly one of --load or --trace is required",
            file=sys.stderr,
        )
        return 2

    if args.load:
        try:
            text = Path(args.load).read_text(encoding="utf-8")
            dump = ledger_from_jsonl(text)
        except (OSError, ValueError) as e:
            print(f"error: cannot load {args.load}: {e}", file=sys.stderr)
            return 2
    else:
        if not args.profile:
            print(
                "error: --trace needs --profile", file=sys.stderr
            )
            return 2
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            out_path = Path(args.out) if args.out else Path(tmp) / "ledger.jsonl"
            serve_argv = [
                "--trace", args.trace,
                "--profile", args.profile,
                "--quiet",
                "--workers", str(args.workers),
                "--mip-gap", str(args.mip_gap),
                "--lp-backend", args.lp_backend,
                "--compile-warm-events", str(args.compile_warm_events),
                "--compile-ledger-out", str(out_path),
            ]
            if args.device:
                serve_argv += ["--device", args.device]
            if args.synthetic_fleet:
                serve_argv += [
                    "--synthetic-fleet", str(args.synthetic_fleet),
                    "--fleet-seed", str(args.fleet_seed),
                ]
            if args.k_candidates:
                serve_argv += ["--k-candidates", args.k_candidates]
            # The delegated serve run's summary goes to stderr: stdout
            # must carry exactly the report (or the --json object), so
            # piping `compiles` stays machine-readable.
            import contextlib
            import io

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = serve_main(serve_argv)
            if buf.getvalue():
                print(buf.getvalue(), end="", file=sys.stderr)
            if rc != 0:
                return rc
            text = out_path.read_text(encoding="utf-8")
            dump = ledger_from_jsonl(text)

    if args.check:
        failures = []
        registry = set(dump["header"].get("registry", []))
        for ev in dump["events"]:
            if ev["entry"] not in registry:
                failures.append(
                    f"compile of unregistered entry {ev['entry']!r} "
                    f"(seq {ev['seq']}) — a capture outside every "
                    "instrumented entry point"
                )
            if ev["cause"] == "recompile":
                failures.append(
                    f"exact-signature recompile of {ev['entry']} "
                    f"(seq {ev['seq']}, static=[{ev['static']}])"
                )
        if ledger_to_jsonl(dump) != text:
            failures.append("ledger JSONL does not round-trip byte-stably")
        if failures:
            for f in failures:
                print(f"compile-ledger check FAILED: {f}", file=sys.stderr)
            return 1

    if args.json:
        print(json.dumps(dump["header"].get("summary", {}), sort_keys=True))
    else:
        print(render_report(dump, top=args.top), end="")
    if args.check:
        n = len(dump["events"])
        print(
            f"compile-ledger check OK: {n} compile event(s), all "
            "registered, no exact-signature recompiles, dump byte-stable"
        )
    return 0


def build_memory_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m distilp_torch.cli.solver_cli memory",
        description="render the memory ledger (obs.memory): per-entry "
        "static memory models (the CUDA allocator's peak over a first "
        "dispatch, its temp/argument/output bytes; a loop plan's owned "
        "bytes), allocated/reserved/RSS watermarks, the warm-path leak-gate "
        "verdict, and ops/memmodel.py's analytic peak beside the measured "
        "figures — from a live run (--trace, replayed through `serve` with "
        "the ledger on) or a dumped "
        "JSONL (--load). Rendering a dump is a pure function: the same "
        "dump produces byte-identical reports on every replay",
    )
    p.add_argument(
        "--load", default=None, metavar="FILE",
        help="render a ledger JSONL previously dumped by "
        "`serve --memory-out` (or --out below); no backend needed",
    )
    p.add_argument(
        "--trace", default=None,
        help="live mode: replay this churn trace (single- or multi-fleet) "
        "with the memory ledger enabled and render the resulting ledger",
    )
    p.add_argument(
        "--profile", "-p", default=None,
        help="profile folder (required with --trace)",
    )
    p.add_argument("--synthetic-fleet", type=int, default=0, metavar="M")
    p.add_argument("--fleet-seed", type=int, default=0)
    p.add_argument("--workers", type=int, default=1)
    p.add_argument("--mip-gap", type=float, default=1e-3)
    p.add_argument("--k-candidates", default=None)
    p.add_argument(
        "--lp-backend", choices=["ipm", "pdhg", "auto"], default="auto",
        help="LP engine pin for the live replay (each engine's entry "
        "points get their own static model)",
    )
    p.add_argument(
        "--warm-events", type=int, default=2, metavar="N",
        help="leak-gate baseline: marked once every replayed fleet has "
        "handled N events (see `serve --compile-warm-events`)",
    )
    p.add_argument(
        "--memory-budget-mb", type=float, default=None,
        help="headroom budget for the live replay (default: MemTotal)",
    )
    _add_device(p)
    p.add_argument(
        "--analytic-m", default=None, metavar="M[,M...]",
        help="fleet sizes to print ops/memmodel.py's analytic peak_bytes for "
        "(both engines) beside the measured figures (default with --trace: "
        "the replayed fleets' sizes)",
    )
    p.add_argument(
        "--out", default=None, metavar="FILE",
        help="also save the live run's ledger JSONL here",
    )
    p.add_argument(
        "--json", action="store_true",
        help="print the ledger summary as one JSON object instead of text",
    )
    p.add_argument(
        "--check", action="store_true",
        help="exit 1 unless the ledger is clean: the leak gate was "
        "marked AND allocated bytes stayed flat across the warm phase, "
        "no watermark sample failed, and the JSONL round-trips "
        "byte-stably (the smoke-memory contract)",
    )
    return p


def memory_main(argv=None) -> int:
    """``memory``: render/check the memory ledger."""
    args = build_memory_parser().parse_args(argv)

    from ..obs.memory import (
        memory_from_jsonl,
        memory_to_jsonl,
        render_report,
    )

    if bool(args.load) == bool(args.trace):
        print(
            "error: exactly one of --load or --trace is required",
            file=sys.stderr,
        )
        return 2

    if args.load:
        try:
            text = Path(args.load).read_text(encoding="utf-8")
            dump = memory_from_jsonl(text)
        except (OSError, ValueError) as e:
            print(f"error: cannot load {args.load}: {e}", file=sys.stderr)
            return 2
    else:
        if not args.profile:
            print("error: --trace needs --profile", file=sys.stderr)
            return 2
        import tempfile

        with tempfile.TemporaryDirectory() as tmp:
            out_path = (
                Path(args.out) if args.out else Path(tmp) / "memory.jsonl"
            )
            serve_argv = [
                "--trace", args.trace,
                "--profile", args.profile,
                "--quiet",
                "--workers", str(args.workers),
                "--mip-gap", str(args.mip_gap),
                "--lp-backend", args.lp_backend,
                "--compile-warm-events", str(args.warm_events),
                "--memory-out", str(out_path),
            ]
            if args.device:
                serve_argv += ["--device", args.device]
            if args.memory_budget_mb is not None:
                serve_argv += [
                    "--memory-budget-mb", str(args.memory_budget_mb),
                ]
            if args.synthetic_fleet:
                serve_argv += [
                    "--synthetic-fleet", str(args.synthetic_fleet),
                    "--fleet-seed", str(args.fleet_seed),
                ]
            if args.k_candidates:
                serve_argv += ["--k-candidates", args.k_candidates]
            # The delegated serve run's summary goes to stderr: stdout
            # must carry exactly the report (or the --json object), the
            # `compiles` convention.
            import contextlib
            import io

            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = serve_main(serve_argv)
            if buf.getvalue():
                print(buf.getvalue(), end="", file=sys.stderr)
            if rc != 0:
                return rc
            text = out_path.read_text(encoding="utf-8")
            dump = memory_from_jsonl(text)

    if args.check:
        failures = []
        summary = dump["header"].get("summary", {})
        leak = summary.get("leak")
        if leak is None and not any(
                r.get("live_bytes") is not None for r in dump["samples"]):
            failures.append(
                "leak gate has no allocated bytes to read (no CUDA device in "
                "the run: the CPU path records them as absent)"
            )
        elif leak is None:
            failures.append(
                "leak gate never marked (the replay ended before the "
                "warm boundary — fewer events than --warm-events?)"
            )
        elif not leak.get("flat"):
            failures.append(
                f"warm serving GREW allocated bytes: "
                f"{leak['baseline_bytes']} -> {leak['last_bytes']} "
                f"({leak['growth_bytes']:+d} B) — drift/spec ticks must "
                "allocate nothing persistent"
            )
        marks = summary.get("watermarks", {})
        if marks.get("sample_errors", 0):
            failures.append(
                f"{marks['sample_errors']} watermark sample(s) failed"
            )
        if memory_to_jsonl(dump) != text:
            failures.append("memory JSONL does not round-trip byte-stably")
        if failures:
            for f in failures:
                print(f"memory-ledger check FAILED: {f}", file=sys.stderr)
            return 1

    if args.json:
        print(json.dumps(dump["header"].get("summary", {}), sort_keys=True))
    else:
        print(render_report(dump), end="")
        sizes = _memory_analytic_sizes(args)
        if sizes:
            print(_render_analytic(dump, sizes), end="")
    if args.check:
        summary = dump["header"].get("summary", {})
        analyzed = sum(
            1
            for e in summary.get("entries", {}).values()
            if e.get("memory")
        )
        print(
            f"memory-ledger check OK: {analyzed} entry model(s), warm "
            "phase flat, dump byte-stable"
        )
    return 0


def _memory_analytic_sizes(args) -> list:
    """The fleet sizes ``memory`` prints the analytic model for."""
    if args.analytic_m:
        return sorted({int(x) for x in args.analytic_m.split(",") if x.strip()})
    if not args.trace:
        return []
    if args.synthetic_fleet:
        return [args.synthetic_fleet]
    from ..gateway.traces import is_gateway_trace, make_fleet_from_spec, read_gateway_trace

    if is_gateway_trace(args.trace):
        specs, _ = read_gateway_trace(args.trace)
        return sorted({len(make_fleet_from_spec(f, spec)) for f, spec in specs.items()})
    from ..common import load_from_profile_folder

    return [len(load_from_profile_folder(Path(args.profile))[0])]


def _render_analytic(dump: dict, sizes) -> str:
    """ops/memmodel.py's analytic peak working set per fleet size and engine,
    beside the largest measured first-dispatch peak of the solver's entry
    points in the dump (a pure function of its arguments)."""
    from ..ops.memmodel import ENGINES, peak_bytes

    entries = dump["header"].get("summary", {}).get("entries", {})
    measured = [
        (e.get("memory") or {}).get("peak_bytes")
        for name, e in entries.items() if name.startswith("solver.")
    ]
    measured = [v for v in measured if v is not None]
    peak = max(measured) if measured else None
    out = ["", "  analytic model (ops/memmodel.peak_bytes, dense) vs measured:"]
    out.append("    measured solver peak (largest first-dispatch delta): "
               + ("n/a" if peak is None else f"{peak} ({peak / 1e6:.2f} MB)"))
    for M in sizes:
        for engine in ENGINES:
            model = peak_bytes(M, engine)
            ratio = "n/a" if peak is None else f"{peak / model:.1f}x"
            out.append(f"    M={M:<5d} {engine:<5s} analytic={model} "
                       f"({model / 1e6:.2f} MB) measured/analytic={ratio}")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "evaluate":
        return evaluate_main(argv[1:])
    if argv and argv[0] == "diagnose":
        return diagnose_main(argv[1:])
    if argv and argv[0] == "serve":
        return serve_main(argv[1:])
    if argv and argv[0] == "spans":
        return spans_main(argv[1:])
    if argv and argv[0] == "overload":
        return overload_main(argv[1:])
    if argv and argv[0] == "slo":
        return slo_main(argv[1:])
    if argv and argv[0] == "autoscale":
        return autoscale_main(argv[1:])
    if argv and argv[0] == "compiles":
        return compiles_main(argv[1:])
    if argv and argv[0] == "memory":
        return memory_main(argv[1:])
    args = build_parser().parse_args(argv)
    if (args.mesh_shards or 1) > 1:
        # As the reference's CLI forces its host mesh: with fewer devices
        # than shards, the shards share them (a virtual mesh).
        from ..parallel import force_virtual_devices

        force_virtual_devices(args.mesh_shards)

    from ..common import load_from_profile_folder
    from ..solver import HALDAResult, halda_solve

    folder = Path(args.profile)
    if not folder.is_dir():
        print(f"error: {folder} is not a directory", file=sys.stderr)
        return 2
    devices, model = load_from_profile_folder(folder)

    expert_loads = None
    if args.expert_loads:
        if args.moe == "off":
            print(
                "error: --expert-loads needs the MoE formulation; it cannot "
                "be combined with --moe off",
                file=sys.stderr,
            )
            return 2
        raw = args.expert_loads
        try:
            if Path(raw).is_file():
                expert_loads = json.loads(Path(raw).read_text())
            else:
                expert_loads = [float(x) for x in raw.split(",") if x.strip()]
            if not isinstance(expert_loads, list) or not all(
                isinstance(x, (int, float)) for x in expert_loads
            ):
                raise ValueError("expected a JSON array of numbers (one load per expert)")
        except (OSError, TypeError, ValueError) as e:
            print(f"error: cannot parse --expert-loads: {e}", file=sys.stderr)
            return 2

    warm = None
    if args.warm_from:
        if args.backend != "torch":
            print(
                "error: --warm-from needs --backend torch (the cpu backend "
                "has no warm-start hook and would ignore the seed)",
                file=sys.stderr,
            )
            return 2
        try:
            # Extra keys (devices, ...) are ignored, so a reload accepts
            # whatever --save-solution of either package writes.
            warm = HALDAResult.model_validate(json.loads(Path(args.warm_from).read_text()))
        except (OSError, TypeError, ValueError) as e:
            print(f"error: cannot load --warm-from: {e}", file=sys.stderr)
            return 2
        if expert_loads is not None:
            print(
                "error: --warm-from cannot be combined with --expert-loads "
                "(the load-aware loop manages its own warm starts)",
                file=sys.stderr,
            )
            return 2

    moe = {"auto": None, "on": True, "off": False}[args.moe]
    search = dict(
        max_rounds=args.max_rounds, beam=args.beam, ipm_iters=args.ipm_iters,
        ipm_warm_iters=args.ipm_warm_iters, node_cap=args.node_cap,
        lp_backend=args.lp_backend, pdhg_iters=args.pdhg_iters,
        pdhg_restart_tol=args.pdhg_restart_tol, batch_size=args.batch_size,
        device=args.device,
    )
    if args.per_k:
        if expert_loads is not None or warm is not None:
            print("error: --per-k cannot combine with --expert-loads or --warm-from",
                  file=sys.stderr)
            return 2
        return _per_k_main(args, devices, model, moe, search)

    mapping = realized = None
    try:
        if expert_loads is not None:
            from ..solver.routing import solve_load_aware

            result, mapping, realized = solve_load_aware(
                devices, model, expert_loads=expert_loads,
                k_candidates=_k_candidates(args.k_candidates), mip_gap=args.mip_gap,
                debug=args.debug, kv_bits=args.kv_bits, backend=args.backend,
                time_limit=args.time_limit, plot=args.plot, **search,
            )
        else:
            result = halda_solve(
                devices, model, k_candidates=_k_candidates(args.k_candidates),
                mip_gap=args.mip_gap, debug=args.debug, kv_bits=args.kv_bits,
                backend=args.backend, time_limit=args.time_limit, moe=moe, warm=warm,
                mesh_shards=args.mesh_shards, pdhg_dtype=args.pdhg_dtype, plot=args.plot,
                **search,
            )
    except (ValueError, NotImplementedError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    result.print_solution(devices)
    status = "certified" if result.certified else "NOT certified"
    gap_txt = f"{result.gap:.3g}" if result.gap is not None else "exact (HiGHS)"
    print(f"Optimality: {status} (achieved gap {gap_txt})")
    if mapping is not None:
        print("Expert routing (load-weighted):")
        for dev, ids, share in zip(devices, mapping.expert_of_device, mapping.load_share):
            print(f"  {dev.name:40s}: {len(ids):3d} experts, "
                  f"{share * 100:5.1f}% of routed load")
        # The certificate above covers the linearized instance; this is the
        # end-to-end objective at the mapping's realized loads (None when
        # the solves ran on the HiGHS oracle).
        if realized is not None:
            print(f"Realized objective (at mapped expert loads): {realized:.6f}")
    if args.save_solution:
        _write_solution(args.save_solution, result, devices, mapping=mapping,
                        realized=realized)
    return 0


def _per_k_main(args, devices, model, moe, search) -> int:
    """``--per-k``: every feasible k to its own certificate, as a table."""
    from ..solver import halda_solve_per_k

    try:
        per_k = halda_solve_per_k(
            devices, model, k_candidates=_k_candidates(args.k_candidates),
            mip_gap=args.mip_gap, kv_bits=args.kv_bits, backend=args.backend, moe=moe,
            mesh_shards=args.mesh_shards, pdhg_dtype=args.pdhg_dtype,
            time_limit=args.time_limit, debug=args.debug, plot=args.plot, **search,
        )
    except (ValueError, NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not per_k:
        print("error: no feasible placement for any k", file=sys.stderr)
        return 1
    print(f"{'k':>5s} {'objective':>14s} {'certified':>9s}  assignment")
    for r in sorted(per_k, key=lambda r: r.k):
        w_txt = ",".join(str(w) for w in r.w)
        y_txt = f" y=[{','.join(str(y) for y in r.y)}]" if r.y else ""
        print(f"{r.k:5d} {r.obj_value:14.6f} {str(r.certified):>9s}  w=[{w_txt}]{y_txt}")
    winner = min(per_k, key=lambda r: r.obj_value)
    print(f"Best: k={winner.k} (objective {winner.obj_value:.6f})")
    if args.save_solution:
        _write_solution(args.save_solution, winner, devices)
    return 0


def _write_solution(path, result, devices, mapping=None, realized=None):
    """The JAX package's solution JSON (so either CLI's ``evaluate
    --solution`` and ``--warm-from`` read it)."""
    payload = {
        "k": result.k,
        "w": result.w,
        "n": result.n,
        "obj_value": result.obj_value,
        "sets": result.sets,
        "devices": [d.name for d in devices],
        "certified": result.certified,
        "gap": result.gap,
    }
    if result.y is not None:
        payload["y"] = result.y
    if result.duals is not None:
        payload["duals"] = result.duals
    if mapping is not None:
        payload["expert_of_device"] = mapping.expert_of_device
        payload["expert_load_share"] = [float(x) for x in mapping.load_share]
        if realized is not None:
            payload["realized_objective"] = realized
    Path(path).write_text(json.dumps(payload, indent=2))
    print(f"Saved solution to {path}")


if __name__ == "__main__":
    raise SystemExit(main())
