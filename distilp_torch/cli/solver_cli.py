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

``--backend torch`` (default) runs the branch-and-bound search on
``--device`` (default cuda; ``cpu`` runs the kernels' plain versions),
``--backend cpu`` the HiGHS oracle. ``--per-k`` certifies every k and prints
the k-curve; ``--expert-loads`` runs the load-aware routing loop; ``--plot``
draws the k-objective curve. The twin's Monte-Carlo engine and ``serve``'s
every solve run on ``--device`` too. Options and subcommands of parts the
port does not have yet exit with code 2 and name their ROADMAP.md item;
none is ignored.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

# Subcommands of the JAX package's CLI that wait for later slices.
DEFERRED_SUBCOMMANDS = {
    "overload": "A12c (open-loop traffic, control and SLO)",
    "autoscale": "A12c (open-loop traffic, control and SLO)",
    "slo": "A12c (open-loop traffic, control and SLO)",
    "compiles": "A14b (compile and memory ledgers for CUDA)",
    "memory": "A14b (compile and memory ledgers for CUDA)",
}


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

# Options of ``serve`` that wait for a later slice, by ROADMAP item. Each one
# that is set exits 2 naming its item; a plain, chaos or gateway ``serve``
# sets none.
_SLO = "A12c (open-loop traffic, control and SLO)"
_LEDGERS = "A14b (compile and memory ledgers for CUDA)"
# (flag, argparse keywords, value that means "not set", ROADMAP item)
_DEFERRED_SERVE = (
    ("--slo", dict(default=None), None, _SLO),
    ("--capacity-eps", dict(type=float, default=None), None, _SLO),
    ("--compile-ledger", dict(action="store_true"), False, _LEDGERS),
    ("--compile-ledger-out", dict(default=None), None, _LEDGERS),
    ("--compile-warm-events", dict(type=int, default=None), None, _LEDGERS),
    ("--memory-ledger", dict(action="store_true"), False, _LEDGERS),
    ("--memory-out", dict(default=None), None, _LEDGERS),
    ("--memory-budget-mb", dict(type=float, default=None), None, _LEDGERS),
    ("--mem-degrade-headroom-mb", dict(type=float, default=None), None, _LEDGERS),
)


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
    _add_gateway_args(p)
    g = p.add_argument_group(
        "options of later slices (each exits 2 naming its ROADMAP item)")
    for flag, kw, _, item in _DEFERRED_SERVE:
        g.add_argument(flag, help=f"ROADMAP {item.split()[0]}", **kw)
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
            or args.degrade_depth is not None or args.worker_backend != "thread"
            or args.scheduler_factory is not None or args.supervise):
        return True
    if Path(args.trace).is_file():
        from ..gateway.traces import is_gateway_trace

        return is_gateway_trace(args.trace)
    return False


def _deferred_serve_options(args) -> list:
    """(option, ROADMAP item) of each ``serve`` option set that a later
    slice ports."""
    return [(flag, item) for flag, _, unset, item in _DEFERRED_SERVE
            if getattr(args, flag[2:].replace("-", "_")) != unset]


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


def _build_timeline(args, metrics, sample_fn):
    """(timeline, sampler) for ``--timeline-dir``, the sampler started; (None,
    None) without it."""
    if not args.timeline_dir:
        return None, None
    from ..obs import Timeline, TimelineSampler

    timeline = Timeline()
    sampler = TimelineSampler(timeline, sample_fn,
                              period_s=max(0.001, args.timeline_period_ms / 1e3),
                              metrics=metrics)
    sampler.start()
    return timeline, sampler


def _timeline_summary(args, timeline, sampler) -> dict:
    """The summary's "slo" block as the reference writes it without an SLO
    spec (+ the timeline dump)."""
    path = Path(args.timeline_dir) / "timeline.jsonl"
    timeline.dump(path)
    return {"samples": sampler.samples, "sample_errors": sampler.errors,
            "series": len(timeline.names()), "timeline_path": str(path)}


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
    deferred = _deferred_serve_options(args)
    if deferred:
        for opt, item in deferred:
            print(f"error: serve {opt} is not part of the port yet (ROADMAP.md {item})",
                  file=sys.stderr)
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

    timeline, sampler = _build_timeline(args, sched.metrics, sched.timeline_sample)
    chaos = None
    try:
        if plan is not None:
            from ..sched import chaos_replay

            chaos = chaos_replay(sched, events, plan, on_event=log_event)
            report = _chaos_to_replay_report(chaos, sched)
        else:
            report = replay(sched, events, on_event=log_event)
    except (RuntimeError, ValueError) as e:
        print(f"error: replay failed: {e}", file=sys.stderr)
        return 1
    finally:
        if sampler is not None:
            sampler.stop()  # before close: no sampling a torn-down daemon
        sched.close()  # release the deadline worker (no-op when unused)
        if tracer is not None:
            tracer.close()  # flush the span JSONL

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
    if sampler is not None:
        summary["slo"] = _timeline_summary(args, timeline, sampler)
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
            degrade_depth=args.degrade_depth, worker_backend=args.worker_backend,
            supervise=args.supervise, recovery_dir=args.recovery_dir,
            snapshot_every=args.snapshot_every, device=device,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    timeline, sampler = _build_timeline(args, gw.metrics, gw.timeline_sample)
    if sampler is not None:
        # Attached: Gateway.close() stops the sampler before the workers.
        gw.attach_sampler(sampler)
        gw.attach_slo(None, timeline)
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
            chaos = chaos_replay(
                facade, [ev for _, ev in run_items], plan,
                on_event=lambda ev, view, ms: log_event("default", ev, view, ms),
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
            summary["slo"] = _timeline_summary(args, timeline, sampler)
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
    if argv and argv[0] in DEFERRED_SUBCOMMANDS:
        print(
            f"error: the '{argv[0]}' subcommand is not part of the port yet "
            f"(ROADMAP.md {DEFERRED_SUBCOMMANDS[argv[0]]})",
            file=sys.stderr,
        )
        return 2
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
