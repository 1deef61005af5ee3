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
  serving tier's metrics at a fixed cadence, with a JSONL dump/load;
- ``convergence`` — typed reports over the solver's convergence telemetry;
- ``compile_ledger`` — the card's cold-start telemetry: every kernel
  library loaded (an ``nvcc`` run or a build-cache hit) and every CUDA
  graph captured, attributed to the port's instrumented entry points and
  classified by cause, a recompile-storm alarm, and the ``compiles``
  report — the layer the zero-recapture warm-serving gate reads;
- ``memory`` — the memory ledger riding the same entry-point registry:
  per-entry static models from the CUDA caching allocator's peak
  statistics, allocated/reserved/RSS watermarks with a warm-path leak gate,
  the ``mem_headroom_bytes`` signal, and the ``memory`` report;
- ``slo`` — declarative SLO specs compiled into error budgets with
  multi-window multi-burn-rate alert rules, the ``GET /slo``/
  ``GET /signals`` payloads (``SignalsPayload`` is the versioned
  autoscaling contract) and the ``slo`` CLI's offline timeline replay.
"""

from . import compile_ledger, memory

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
from .slo import (
    AlertRule,
    BurnWindow,
    SignalsPayload,
    SLOConfig,
    SLOEngine,
    SLOSpec,
    build_signals,
)
from .timeline import (
    Timeline,
    TimelineSampler,
    flatten_metrics_snapshot,
    synthesize_overload_timeline,
)
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
    "synthesize_overload_timeline",
    "SLOConfig",
    "SLOSpec",
    "SLOEngine",
    "AlertRule",
    "BurnWindow",
    "SignalsPayload",
    "build_signals",
    "compile_ledger",
    "memory",
    "CONV_DIGEST_KEYS",
    "LPChunkSample",
    "ConvergenceTrace",
    "RoundRecord",
    "SearchTrace",
    "build_search_trace",
    "search_trace_to_jsonl",
    "search_trace_from_jsonl",
]
