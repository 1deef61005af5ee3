"""Observability of the port (``distilp_tpu/obs``, ported piece by piece):

- ``trace``  — span-based tracing of the serving path (tick -> solve ->
  publish), a bounded finished-span ring, a JSONL writer, and the NOOP
  twins that make the disabled path free;
- ``export`` — span JSONL -> Chrome trace-event JSON (the ``spans`` CLI)
  and the labeled Prometheus text exposition of scheduler metrics (+ the
  parser that round-trips it);
- ``flight`` — the flight recorder: per-shard rings of the last N tick
  records, dumped to a post-mortem JSONL on breaker-open or a
  chaos-contract violation;
- ``timeline`` — bounded per-series time series sampled from the
  scheduler's metrics at a fixed cadence, with a JSONL dump/load;
- ``convergence`` — typed reports over the solver's convergence telemetry.

Not ported yet: the SLO engine (ROADMAP A12c) and the compile and memory
ledgers (ROADMAP A14b).
"""

from .convergence import (
    CONV_DIGEST_KEYS,
    ConvergenceTrace,
    LPChunkSample,
    RoundRecord,
    SearchTrace,
    build_search_trace,
    search_trace_from_jsonl,
    search_trace_to_jsonl,
)
from .export import (
    parse_prometheus_text,
    read_spans,
    render_prometheus,
    span_stats,
    spans_to_chrome,
    top_spans,
)
from .flight import FlightRecorder
from .timeline import Timeline, TimelineSampler, flatten_metrics_snapshot
from .trace import (
    NOOP_SPAN,
    NOOP_TRACER,
    JsonlSpanWriter,
    Span,
    SpanContext,
    Tracer,
    now_ms,
)

__all__ = [
    "Tracer",
    "Span",
    "SpanContext",
    "JsonlSpanWriter",
    "NOOP_TRACER",
    "NOOP_SPAN",
    "now_ms",
    "read_spans",
    "spans_to_chrome",
    "top_spans",
    "span_stats",
    "render_prometheus",
    "parse_prometheus_text",
    "FlightRecorder",
    "Timeline",
    "TimelineSampler",
    "flatten_metrics_snapshot",
    "CONV_DIGEST_KEYS",
    "LPChunkSample",
    "ConvergenceTrace",
    "RoundRecord",
    "SearchTrace",
    "build_search_trace",
    "search_trace_to_jsonl",
    "search_trace_from_jsonl",
]
