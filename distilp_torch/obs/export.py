"""Span and metrics exporters: Chrome trace JSON + Prometheus text.

Two consumers, two formats:

- **Chrome trace-event JSON** (``spans_to_chrome``): the span JSONL a
  ``serve --trace-spans-dir`` run wrote, converted into a file Perfetto or
  ``chrome://tracing`` loads directly — one track per thread (the gateway
  workers each get their own), spans as complete ("X") events, span events
  as instants, and every ``gateway.queue_wait`` span drawn as a FLOW arrow
  from the submitting thread to the worker that picked the tick up (the
  visual for the queue-wait number that diagnoses worker thrash). The
  ``solver spans`` CLI subcommand is a thin wrapper over this.

- **Prometheus v0.0.4 text** (``render_prometheus``): the gateway's
  per-shard ``SchedulerMetrics`` as labeled samples —
  ``{fleet,shard,worker,health}`` — so per-shard counters surface through
  one scrape instead of being summed away; latency histograms render as
  summaries (p50/p99 quantiles + ``_sum``/``_count``). ``# HELP`` text
  comes from ``sched.metrics.METRIC_REGISTRY`` (the same registry dlint
  DLP019 holds every literal counter name to), so dashboards and code
  cannot drift apart. ``parse_prometheus_text`` is the minimal in-repo
  parser the round-trip tests (and any quick operator sanity check) use.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

__all__ = [
    "read_spans",
    "spans_to_chrome",
    "top_spans",
    "span_stats",
    "render_prometheus",
    "parse_prometheus_text",
]


# -- span JSONL -> Chrome trace-event JSON ----------------------------------


def read_spans(path) -> List[dict]:
    """Parse a span JSONL file (one span object per line, blanks skipped)."""
    out: List[dict] = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out


def spans_to_chrome(spans: List[dict]) -> dict:
    """Chrome trace-event JSON for a list of span records.

    Timestamps convert ms -> µs (the trace-event unit). Thread tracks are
    minted in first-appearance order with metadata events naming them, so
    Perfetto shows ``gw-worker-0`` / ``gw-worker-1`` / the loop thread as
    separate rows. Queue waits additionally emit an ``s``/``f`` flow pair:
    the arrow starts on the thread that ENQUEUED (the queue-wait span's
    parent's thread) and lands on the worker thread at pickup.
    """
    tids: Dict[str, int] = {}
    events: List[dict] = []
    by_id = {s["span_id"]: s for s in spans}

    def tid_for(thread: str) -> int:
        if thread not in tids:
            tids[thread] = len(tids) + 1
            events.append(
                {
                    "ph": "M",
                    "name": "thread_name",
                    "pid": 1,
                    "tid": tids[thread],
                    "args": {"name": thread},
                }
            )
        return tids[thread]

    for s in spans:
        tid = tid_for(s.get("thread", "main"))
        t0_us = s["t0_ms"] * 1e3
        dur_us = max(0.0, s["dur_ms"]) * 1e3
        events.append(
            {
                "name": s["name"],
                "cat": "distilp",
                "ph": "X",
                "pid": 1,
                "tid": tid,
                "ts": t0_us,
                "dur": dur_us,
                "args": {
                    "trace_id": s["trace_id"],
                    "span_id": s["span_id"],
                    **(s.get("attrs") or {}),
                },
            }
        )
        for ev in s.get("events") or []:
            events.append(
                {
                    "name": ev.get("name", "event"),
                    "cat": "distilp",
                    "ph": "i",
                    "s": "t",
                    "pid": 1,
                    "tid": tid,
                    "ts": ev.get("t_ms", s["t0_ms"]) * 1e3,
                    "args": {
                        k: v for k, v in ev.items() if k not in ("name", "t_ms")
                    },
                }
            )
        if s["name"] == "gateway.queue_wait":
            parent = by_id.get(s.get("parent_id") or "")
            src_tid = tid_for(parent["thread"]) if parent else tid
            flow_id = int(s["span_id"], 16)
            events.append(
                {
                    "name": "queue", "cat": "flow", "ph": "s", "id": flow_id,
                    "pid": 1, "tid": src_tid, "ts": t0_us,
                }
            )
            events.append(
                {
                    "name": "queue", "cat": "flow", "ph": "f", "bp": "e",
                    "id": flow_id, "pid": 1, "tid": tid,
                    "ts": t0_us + dur_us,
                }
            )
    # Stable load order: metadata first (ph M has no ts), then by time.
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def top_spans(spans: List[dict], n: int = 3) -> List[dict]:
    """The n slowest spans (the walkthrough's "where did the time go")."""
    return sorted(spans, key=lambda s: s.get("dur_ms", 0.0), reverse=True)[:n]


def span_stats(spans: List[dict], top: int = 3) -> List[dict]:
    """Per-span-name aggregates for CI logs: Perfetto is the deep-dive
    tool, but a test log needs "which span got slow" as TEXT. One row per
    span name — count, total/p50/p99/max duration, and the ``top``
    slowest instances with their trace ids (the handle a post-mortem
    greps the span JSONL for). Rows sort by total duration, descending —
    the"where did the wall clock go" order."""
    from ..sched.metrics import _quantile

    by_name: Dict[str, List[dict]] = {}
    for s in spans:
        by_name.setdefault(s.get("name", "?"), []).append(s)
    rows: List[dict] = []
    for name, group in by_name.items():
        durs = sorted(float(s.get("dur_ms", 0.0)) for s in group)
        slowest = sorted(
            group, key=lambda s: s.get("dur_ms", 0.0), reverse=True
        )[:top]
        rows.append(
            {
                "name": name,
                "count": len(group),
                "total_ms": round(sum(durs), 3),
                "p50_ms": round(_quantile(durs, 0.50), 3),
                "p99_ms": round(_quantile(durs, 0.99), 3),
                "max_ms": round(durs[-1], 3) if durs else 0.0,
                "slowest": [
                    {
                        "dur_ms": s.get("dur_ms", 0.0),
                        "trace_id": s.get("trace_id"),
                        "thread": s.get("thread"),
                    }
                    for s in slowest
                ],
            }
        )
    rows.sort(key=lambda r: r["total_ms"], reverse=True)
    return rows


# -- Prometheus v0.0.4 text exposition --------------------------------------

_PROM_PREFIX = "distilp_"
_WORKER_EVENTS_RE = re.compile(r"^worker_(\d+)_events$")
_HEALTH_RANK = {"healthy": 0, "degraded": 1, "broken": 2}


def _escape_label(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _labels_txt(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def _help_for(name: str) -> str:
    from ..sched.metrics import registry_help

    return registry_help(name) or "distilp metric (unregistered)"


class _PromDoc:
    """Accumulates samples per metric name, renders HELP/TYPE + samples."""

    def __init__(self) -> None:
        # name -> (type, help, [(labels, value)])
        self._metrics: Dict[str, Tuple[str, str, list]] = {}

    def add(
        self,
        name: str,
        value,
        labels: Dict[str, str],
        mtype: str = "counter",
        help_name: Optional[str] = None,
    ) -> None:
        full = _PROM_PREFIX + name
        if full not in self._metrics:
            self._metrics[full] = (mtype, _help_for(help_name or name), [])
        self._metrics[full][2].append((dict(labels), value))

    def add_summary(
        self, name: str, snap: dict, labels: Dict[str, str]
    ) -> None:
        """A LatencyHist snapshot as a Prometheus summary (ms units).

        Quantiles come from the hist's cap-bounded recent window, the
        ``_sum``/``_count`` pair from the all-time fields — exactly the
        split ``LatencyHist.snapshot`` documents.
        """
        full = _PROM_PREFIX + name
        if full not in self._metrics:
            self._metrics[full] = ("summary", _help_for(name), [])
        _, _, samples = self._metrics[full]
        for q, key in (("0.5", "p50_ms"), ("0.99", "p99_ms")):
            samples.append(({**labels, "quantile": q}, snap.get(key, 0.0)))
        count = snap.get("count", 0)
        # Exact running total when the snapshot carries it: reconstructing
        # the sum as rounded-mean*count can DECREASE between scrapes
        # (rounding flips while count grows), which reads as a counter
        # reset and spikes rate() negative.
        total = snap.get("total_ms")
        if total is None:
            total = round(snap.get("mean_ms", 0.0) * count, 3)
        samples.append(({**labels, "__suffix__": "_sum"}, total))
        samples.append(({**labels, "__suffix__": "_count"}, count))

    def render(self) -> str:
        lines: List[str] = []
        for full in sorted(self._metrics):
            mtype, help_txt, samples = self._metrics[full]
            lines.append(f"# HELP {full} {help_txt}")
            lines.append(f"# TYPE {full} {mtype}")
            for labels, value in samples:
                suffix = labels.pop("__suffix__", "")
                lines.append(f"{full}{suffix}{_labels_txt(labels)} {value}")
        return "\n".join(lines) + "\n"


def render_prometheus(
    shards: List[dict],
    gateway_counters: Optional[dict] = None,
    gateway_latency: Optional[dict] = None,
    worker_gauges: Optional[Dict[str, Dict[str, float]]] = None,
) -> str:
    """Prometheus v0.0.4 text for gateway + per-shard scheduler metrics.

    ``shards`` entries carry ``fleet``/``shard``/``worker``/``health`` plus
    the shard scheduler's ``counters`` and ``latency`` snapshot dicts;
    every per-shard sample is labeled with all four, so two shards of the
    same gateway stay distinguishable in one scrape. Gateway-level
    counters render unlabeled, except the ``worker_<i>_events`` family,
    which folds into one ``worker_events`` metric with a ``worker`` label.
    ``worker_gauges`` maps gauge name -> {worker id -> live value} (e.g.
    ``worker_queue_depth``, the admission-control input), rendered as one
    ``worker``-labeled gauge per name.
    """
    doc = _PromDoc()
    for entry in shards:
        labels = {
            "fleet": entry["fleet"],
            "shard": entry["shard"],
            "worker": str(entry["worker"]),
        }
        for name, value in sorted(entry.get("counters", {}).items()):
            doc.add(name, value, labels)
        # Health is deliberately NOT an identity label on the counter and
        # summary series above: it is volatile, and a healthy->degraded
        # flip would mint brand-new series for every counter exactly when
        # rate()/increase() over the transition matters most. It rides
        # here instead — a gauge whose VALUE is the health rank, with the
        # state string as a label on this one metric only.
        doc.add(
            "health_state",
            _HEALTH_RANK.get(entry["health"], 2),
            {**labels, "health": entry["health"]},
            mtype="gauge",
        )
        for name, snap in sorted(entry.get("latency", {}).items()):
            doc.add_summary(name, snap, labels)
    for name, value in sorted((gateway_counters or {}).items()):
        m = _WORKER_EVENTS_RE.match(name)
        if m:
            doc.add(
                "worker_events", value, {"worker": m.group(1)},
                help_name="worker_events",
            )
        else:
            doc.add(name, value, {})
    for name, snap in sorted((gateway_latency or {}).items()):
        doc.add_summary(name, snap, {})
    for name, per_worker in sorted((worker_gauges or {}).items()):
        for worker_id, value in sorted(per_worker.items()):
            doc.add(name, value, {"worker": str(worker_id)}, mtype="gauge")
    return doc.render()


# -- the minimal parser (round-trip tests, operator sanity checks) ----------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)\s*$"
)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_UNESCAPE_RE = re.compile(r"\\(.)")


def _unescape_label(value: str) -> str:
    # One left-to-right pass: sequential str.replace calls corrupt values
    # where an earlier replacement manufactures a later escape (a literal
    # backslash followed by 'n' must stay backslash+n, not newline).
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), value
    )


def parse_prometheus_text(text: str) -> dict:
    """Parse v0.0.4 exposition text into ``{help, type, samples}``.

    ``samples`` is a list of ``(name, labels_dict, value)``; malformed
    lines raise (the round-trip test exists to catch renderer drift, so a
    lenient parser would defeat it).
    """
    helps: Dict[str, str] = {}
    types: Dict[str, str] = {}
    samples: List[Tuple[str, Dict[str, str], float]] = []
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            name, _, txt = line[len("# HELP "):].partition(" ")
            helps[name] = txt
            continue
        if line.startswith("# TYPE "):
            name, _, txt = line[len("# TYPE "):].partition(" ")
            types[name] = txt.strip()
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed exposition line: {raw!r}")
        labels = {
            k: _unescape_label(v)
            for k, v in _LABEL_RE.findall(m.group("labels") or "")
        }
        samples.append((m.group("name"), labels, float(m.group("value"))))
    return {"help": helps, "type": types, "samples": samples}
