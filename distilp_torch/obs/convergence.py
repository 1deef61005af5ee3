"""Solver-interior convergence reports: typed views of the search's
telemetry.

A solve run with a convergence dict (``halda_solve(convergence={})``,
``solve_sweep_torch``) records two things about its own interior: a
per-chunk LP convergence trace of the root round (residual norms, duality
gap, Halpern restarts; ``ops/ipm.py`` ``TRACE_COLS``, written by kernels K1
and K5) and a per-branch-and-bound-round search log (nodes expanded,
incumbent, proven bound, LP iterations spent; ``solver/search.py``
``RL_COLS``). Both are decoded into one plain-lists dict, in the JAX
package's layout; this module turns that dict into pydantic reports:

- :class:`ConvergenceTrace` - one LP element's (one k's root relaxation)
  chunk-by-chunk trajectory;
- :class:`SearchTrace` - the whole search: one :class:`RoundRecord` per
  executed round plus the root traces, with the derived facts
  (``rounds_to_certify``, ``iters_to_certify``, total restarts, the final
  certified gap);
- :func:`SearchTrace.digest` - the flat ``conv_*`` scalar dict that rides
  ``timings``;
- a JSONL round trip (:func:`search_trace_to_jsonl` /
  :func:`search_trace_from_jsonl`) for ``solver diagnose --out`` exports.

The port's own copy of ``distilp_tpu/obs/convergence.py``: the same keys,
reports and JSONL, so a dict or an export of either package loads in the
other. It imports neither torch nor numpy nor the solver.
"""

from __future__ import annotations

import json
import math
from typing import List, Optional

from pydantic import BaseModel

__all__ = [
    "CONV_DIGEST_KEYS",
    "LPChunkSample",
    "ConvergenceTrace",
    "RoundRecord",
    "SearchTrace",
    "build_search_trace",
    "search_trace_to_jsonl",
    "search_trace_from_jsonl",
]

# Every key SearchTrace.digest() can emit: the one enumeration a consumer
# filters timings by.
CONV_DIGEST_KEYS = (
    "conv_rounds",
    "conv_lp_iters",
    "conv_restarts",
    "conv_certified",
    "conv_final_gap",
    "conv_rounds_to_certify",
    "conv_iters_to_certify",
    "conv_final_rp",
    "conv_final_rd",
)


def _clean(v) -> Optional[float]:
    """A JSON-safe float or None: non-finite sentinel values (±inf from
    'no incumbent yet' / 'subtree exhausted', NaN artifacts) decode to
    None rather than leak into reports that get json.dumps'd."""
    if v is None:
        return None
    v = float(v)
    return v if math.isfinite(v) else None


def _rel_gap(inc, bound) -> Optional[float]:
    """Relative optimality gap of an (incumbent, bound) pair; None when it
    is undefined (no incumbent, or an unexplored -inf bound). A +inf bound
    means every subtree was exhausted or pruned — the gap is closed."""
    if inc is None or not math.isfinite(inc):
        return None
    if bound is not None and math.isinf(bound) and bound > 0:
        return 0.0
    if bound is None or not math.isfinite(bound):
        return None
    if inc == 0.0:
        return max(0.0, inc - bound)
    return max(0.0, (inc - bound) / abs(inc))


class LPChunkSample(BaseModel):
    """One chunk-boundary row of an LP kernel's convergence trace."""

    iters: int  # cumulative iterations executed at this boundary
    rp_norm: float  # primal residual inf-norm (scaled system)
    rd_norm: float  # dual residual inf-norm (scaled system)
    gap: float  # engine gauge: complementarity mu (ipm) / norm. gap (pdhg)
    restarts: int  # cumulative Halpern restart chunks (0 for ipm)


class ConvergenceTrace(BaseModel):
    """One LP element's chunk-by-chunk convergence trajectory."""

    engine: str  # 'ipm' | 'pdhg'
    element: int  # batch row (root traces: the k-grid index)
    k: Optional[int] = None  # segment count, when the element maps to one
    samples: List[LPChunkSample]

    @property
    def iters(self) -> int:
        return self.samples[-1].iters if self.samples else 0

    @property
    def restarts(self) -> int:
        return self.samples[-1].restarts if self.samples else 0

    @property
    def final_rp(self) -> Optional[float]:
        return self.samples[-1].rp_norm if self.samples else None

    @property
    def final_rd(self) -> Optional[float]:
        return self.samples[-1].rd_norm if self.samples else None

    @property
    def final_gap(self) -> Optional[float]:
        return self.samples[-1].gap if self.samples else None


class RoundRecord(BaseModel):
    """One executed branch-and-bound round."""

    round: int  # 0 = the root round
    nodes_expanded: int  # frontier rows given an LP solve this round
    nodes_live: int  # live nodes after pruning/branching
    incumbent: Optional[float] = None  # best integer objective so far
    bound: Optional[float] = None  # proven lower bound after the round
    gap: Optional[float] = None  # relative (incumbent, bound) gap
    lp_iters: int = 0  # LP iterations this round actually executed


class SearchTrace(BaseModel):
    """The whole search: per-round records + root LP traces + the facts
    derived from them. Built by :func:`build_search_trace`."""

    lp_backend: str
    mip_gap: float
    incumbent: Optional[float] = None
    best_bound: Optional[float] = None
    certified: bool = False
    final_gap: Optional[float] = None
    lp_iters_executed: int = 0  # the header counter (sums the rounds)
    rounds: List[RoundRecord]
    root_traces: List[ConvergenceTrace]
    rounds_to_certify: Optional[int] = None  # executed rounds until the
    #                                          gap first closed; None = never
    iters_to_certify: Optional[int] = None  # cumulative LP iters to there
    restarts: int = 0  # total Halpern restarts across the root traces

    def digest(self) -> dict:
        """Flat ``conv_*`` scalars for ``timings`` / span attrs / flight
        records; None-valued facts are omitted so the default timings dict
        never grows null keys."""
        final_rps = [
            t.final_rp for t in self.root_traces if t.final_rp is not None
        ]
        final_rds = [
            t.final_rd for t in self.root_traces if t.final_rd is not None
        ]
        out = {
            "conv_rounds": len(self.rounds),
            "conv_lp_iters": self.lp_iters_executed,
            "conv_restarts": self.restarts,
            "conv_certified": bool(self.certified),
        }
        if self.final_gap is not None:
            out["conv_final_gap"] = self.final_gap
        if self.rounds_to_certify is not None:
            out["conv_rounds_to_certify"] = self.rounds_to_certify
        if self.iters_to_certify is not None:
            out["conv_iters_to_certify"] = self.iters_to_certify
        if final_rps:
            out["conv_final_rp"] = max(final_rps)
        if final_rds:
            out["conv_final_rd"] = max(final_rds)
        return out

    def render_text(self, max_lp_rows: int = 12) -> str:
        """The ``solver diagnose`` tables: a per-round search table, then
        each root LP trace (up to ``max_lp_rows`` chunk rows per element,
        tail-biased — the end of a trajectory is where convergence or a
        stall shows)."""

        def f(v, spec="14.6f"):
            return format(v, spec) if v is not None else " " * 10 + "n/a "

        def g(v):
            return f"{v:10.3e}" if v is not None else "       n/a"

        lines = [
            f"search: engine={self.lp_backend} certified={self.certified} "
            f"final_gap={g(self.final_gap).strip()} (mip_gap {self.mip_gap:g})",
            f"rounds={len(self.rounds)} lp_iters={self.lp_iters_executed} "
            f"restarts={self.restarts} "
            f"rounds_to_certify={self.rounds_to_certify} "
            f"iters_to_certify={self.iters_to_certify}",
            f"{'round':>5s} {'expanded':>8s} {'live':>5s} "
            f"{'incumbent':>14s} {'bound':>14s} {'gap':>10s} {'lp_iters':>8s}",
        ]
        for r in self.rounds:
            lines.append(
                f"{r.round:5d} {r.nodes_expanded:8d} {r.nodes_live:5d} "
                f"{f(r.incumbent)} {f(r.bound)} {g(r.gap)} {r.lp_iters:8d}"
            )
        for t in self.root_traces:
            if not t.samples:
                continue
            k_txt = f" k={t.k}" if t.k is not None else ""
            lines.append(
                f"root LP trace [{t.engine}] element {t.element}{k_txt}: "
                f"{t.iters} iters, {t.restarts} restarts"
            )
            shown = t.samples[-max_lp_rows:]
            skipped = len(t.samples) - len(shown)
            if skipped:
                lines.append(f"  ... {skipped} earlier chunk row(s) elided")
            for s in shown:
                lines.append(
                    f"  it={s.iters:6d} rp={s.rp_norm:9.3e} "
                    f"rd={s.rd_norm:9.3e} gap={s.gap:9.3e} "
                    f"restarts={s.restarts}"
                )
        return "\n".join(lines)


def build_search_trace(conv: dict) -> SearchTrace:
    """A :class:`SearchTrace` from the raw convergence dict
    ``halda_solve(convergence=...)`` fills (plain nested lists; see
    ``backend_torch._decode_convergence`` for the layout)."""
    engine = str(conv.get("lp_backend", "ipm"))
    mip_gap = float(conv.get("mip_gap", 0.0))
    ks = list(conv.get("ks", []))

    rounds: List[RoundRecord] = []
    for row in conv.get("round_log", []):
        idx, expanded, live, inc, bound, lp_iters = row
        inc_c, bound_c = _clean(inc), _clean(bound)
        rounds.append(
            RoundRecord(
                round=int(idx),
                nodes_expanded=int(round(expanded)),
                nodes_live=int(round(live)),
                incumbent=inc_c,
                bound=bound_c,
                gap=_rel_gap(inc_c, float(bound)),
                lp_iters=int(round(lp_iters)),
            )
        )

    traces: List[ConvergenceTrace] = []
    for e, rows in enumerate(conv.get("root_trace", [])):
        samples = [
            LPChunkSample(
                iters=int(round(r[0])),
                rp_norm=float(r[1]),
                rd_norm=float(r[2]),
                gap=float(r[3]),
                restarts=int(round(r[4])),
            )
            for r in rows
            if r[5] > 0.5  # live rows are the element's valid samples
        ]
        traces.append(
            ConvergenceTrace(
                engine=engine,
                element=e,
                k=int(ks[e]) if e < len(ks) else None,
                samples=samples,
            )
        )

    inc = _clean(conv.get("incumbent"))
    bound_raw = conv.get("best_bound")
    final_gap = _rel_gap(
        inc, float(bound_raw) if bound_raw is not None else None
    )
    certified = final_gap is not None and final_gap <= mip_gap + 1e-12

    rounds_to_certify = None
    iters_to_certify = None
    seen_iters = 0
    for n, r in enumerate(rounds, start=1):
        seen_iters += r.lp_iters
        if r.gap is not None and r.gap <= mip_gap + 1e-12:
            rounds_to_certify = n
            iters_to_certify = seen_iters
            break

    return SearchTrace(
        lp_backend=engine,
        mip_gap=mip_gap,
        incumbent=inc,
        best_bound=_clean(bound_raw),
        certified=certified,
        final_gap=final_gap,
        lp_iters_executed=int(round(conv.get("ipm_iters_executed", 0.0))),
        rounds=rounds,
        root_traces=traces,
        rounds_to_certify=rounds_to_certify,
        iters_to_certify=iters_to_certify,
        restarts=sum(t.restarts for t in traces),
    )


# -- JSONL round trip (solver diagnose --out / --load) ----------------------

_HEADER_FIELDS = (
    "lp_backend", "mip_gap", "incumbent", "best_bound", "certified",
    "final_gap", "lp_iters_executed", "rounds_to_certify",
    "iters_to_certify", "restarts",
)


def search_trace_to_jsonl(trace: SearchTrace) -> str:
    """One ``search`` header line, one ``round`` line per round, one ``lp``
    line per root trace element — greppable, streamable, and loadable back
    with :func:`search_trace_from_jsonl`."""
    lines = [
        json.dumps(
            {"type": "search", **{f: getattr(trace, f) for f in _HEADER_FIELDS}}
        )
    ]
    for r in trace.rounds:
        lines.append(json.dumps({"type": "round", **r.model_dump()}))
    for t in trace.root_traces:
        lines.append(
            json.dumps(
                {
                    "type": "lp",
                    "engine": t.engine,
                    "element": t.element,
                    "k": t.k,
                    "samples": [s.model_dump() for s in t.samples],
                }
            )
        )
    return "\n".join(lines) + "\n"


def search_trace_from_jsonl(text: str) -> SearchTrace:
    """Rebuild a :class:`SearchTrace` from an exported JSONL. Malformed
    input raises ValueError — a diagnose report silently missing its
    rounds would defeat the non-empty acceptance gate."""
    header = None
    rounds: List[RoundRecord] = []
    traces: List[ConvergenceTrace] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        rec = json.loads(line)
        kind = rec.pop("type", None)
        if kind == "search":
            header = rec
        elif kind == "round":
            rounds.append(RoundRecord.model_validate(rec))
        elif kind == "lp":
            traces.append(
                ConvergenceTrace(
                    engine=rec["engine"],
                    element=rec["element"],
                    k=rec.get("k"),
                    samples=[
                        LPChunkSample.model_validate(s)
                        for s in rec.get("samples", [])
                    ],
                )
            )
        else:
            raise ValueError(f"unknown diagnose JSONL record type {kind!r}")
    if header is None:
        raise ValueError("diagnose JSONL has no 'search' header line")
    return SearchTrace(**header, rounds=rounds, root_traces=traces)
