"""Memory ledger: per-entry static models + live watermarks + leak gate.

The port's counterpart of ``distilp_tpu/obs/memory.py``, over the CUDA
caching allocator instead of XLA's buffer assignment:

- **Static model per entry point.** The ledger rides the compile ledger's
  ``instrument()`` registry (a dispatch hook, see
  ``compile_ledger.set_dispatch_hook``): the first time a registered
  entry point is dispatched from Python on a CUDA device (never while a
  graph capture is open on the thread, never inside another entry's
  analysis), the ledger brackets the call with the allocator's peak
  statistics and records the peak-allocation delta of that first
  dispatch (``peak_bytes``; ``reserved_bytes``, the growth of the
  allocator's reserved pool), the bytes of the call's device tensor
  arguments (``argument_bytes``) and of its device tensor results
  (``output_bytes``), and the rest of the peak (``temp_bytes``). What the
  port cannot tell apart (aliasing, generated code, host temporaries) is
  ``None``: absent, never zero. A loop plan's static model
  (``solver.device_loop.plan``) is the bytes of the device buffers the
  plan owns. On the CPU every device field is ``None``.
- **Live watermarks.** ``sample()`` records the allocator's allocated,
  reserved and peak-allocated bytes per CUDA device
  (``torch.cuda.memory_allocated``/``memory_reserved``/
  ``max_memory_allocated``) plus host RSS/HWM parsed stdlib-only from
  ``/proc/self/status`` (``VmHWM`` is absent on some container kernels —
  absent fields stay ``None``). Samples are throttled
  (``sample_min_interval_s``); the serving path attaches watermark attrs
  only on ticks where a fresh sample actually landed.
- **Leak gate.** ``mark_warm()`` pins the warm-serving baseline;
  ``leak_report()`` compares the newest allocated bytes against it. The
  warm path's contract is FLAT — drift/spec/spec_near ticks allocate
  nothing persistent.
- **Headroom.** ``headroom_bytes()`` = budget - RSS (budget defaults to
  ``/proc/meminfo`` MemTotal; override per deployment). It feeds the
  ``mem_headroom_bytes`` field of ``GET /signals`` and the gateway's
  optional degrade-on-low-headroom admission hint.

Stdlib-only at import (torch loads lazily inside the sampling and analysis
paths), opt-in (no ledger enabled means the instrumented entry points run
the exact pre-ledger path — one extra module-global read per dispatch), and
JSONL persistence follows the flight-recorder convention with a byte-stable
round trip; ``render_report`` is a pure function of a dump (the JAX
package's, byte for byte), so ``memory`` renders identical bytes on every
replay of the same dump.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import compile_ledger as _cl
from ..utils.lockwatch import make_lock

__all__ = [
    "MemoryLedger",
    "enable",
    "disable",
    "current",
    "parse_proc_status",
    "read_proc_status",
    "read_meminfo_total",
    "device_memory",
    "device_bytes",
    "note_plan",
    "memory_to_jsonl",
    "memory_from_jsonl",
    "render_report",
    "PLAN_ENTRY",
]

# The static model's fields, the dump keys of the JAX package's XLA memory
# analysis plus the port's own peak and reserved-pool deltas. A field the
# port cannot tell apart is None (absent, never zero).
MEM_ANALYSIS_FIELDS = (
    "temp_bytes",
    "argument_bytes",
    "output_bytes",
    "alias_bytes",
    "generated_code_bytes",
    "host_temp_bytes",
    "peak_bytes",
    "reserved_bytes",
)
# The entry a loop plan's static model is recorded under.
PLAN_ENTRY = "solver.device_loop.plan"

_tls = threading.local()
_LEDGER: Optional["MemoryLedger"] = None
_LEDGER_LOCK = make_lock("memory_ledger.global")
# One first-dispatch analysis at a time in the process: the allocator's
# peak statistic is per device, so two overlapping analyses would read
# each other's peaks (a busy analysis lock defers the other entry to a
# later dispatch).
_ANALYSIS_LOCK = threading.Lock()


# -- stdlib probes ------------------------------------------------------------


def _kb_value(line: str) -> Optional[int]:
    """Bytes from a ``Vm...:   1234 kB`` /proc status line; None when the
    line does not parse (proc(5) promises kB, but a parser that crashes
    on a weird kernel would take the watermark sampler down with it)."""
    parts = line.split()
    if len(parts) < 2:
        return None
    try:
        kb = int(parts[1])
    except ValueError:  # dlint: disable=DLP017 the None return IS the signal (absent-not-zero contract): every consumer renders it as n/a, and the summary's sample accounting stays intact
        return None
    return kb * 1024


def parse_proc_status(text: str) -> Dict[str, Optional[int]]:
    """``{"rss_bytes", "hwm_bytes"}`` from a ``/proc/<pid>/status`` blob.

    ``VmHWM`` is missing on some container/sandbox kernels (this repo's
    own CI box among them) — a missing field is ``None``, and every
    consumer treats None as "absent", never as zero.
    """
    out: Dict[str, Optional[int]] = {"rss_bytes": None, "hwm_bytes": None}
    for line in text.splitlines():
        if line.startswith("VmRSS:"):
            out["rss_bytes"] = _kb_value(line)
        elif line.startswith("VmHWM:"):
            out["hwm_bytes"] = _kb_value(line)
    return out


def read_proc_status(path: str = "/proc/self/status") -> Dict[str, Optional[int]]:
    """Parsed RSS/HWM of this process; all-None off Linux (no /proc)."""
    try:
        with open(path, "r", encoding="ascii", errors="replace") as fh:
            text = fh.read()
    except OSError:  # dlint: disable=DLP017 no /proc on this platform: the all-None record IS the signal (absent-not-zero), rendered as n/a everywhere — not a fault to count
        return {"rss_bytes": None, "hwm_bytes": None}
    return parse_proc_status(text)


def read_meminfo_total(path: str = "/proc/meminfo") -> Optional[int]:
    """MemTotal in bytes — the default headroom budget when none is
    configured; None off Linux (headroom then reports None, not a lie)."""
    try:
        with open(path, "r", encoding="ascii", errors="replace") as fh:
            for line in fh:
                if line.startswith("MemTotal:"):
                    return _kb_value(line)
    except OSError:  # dlint: disable=DLP017 no /proc on this platform: a None budget makes headroom report None (honest absence), never a fabricated number
        return None
    return None


def device_memory() -> dict:
    """The CUDA caching allocator's bytes over every visible device:
    ``{"allocated_bytes", "reserved_bytes", "max_allocated_bytes",
    "by_device"}`` (``by_device``: allocated bytes by ``cuda:<i>``).

    Every field is None (absent, never zero) when torch is not loaded, has
    no CUDA device, or has not initialised CUDA in this process yet (the
    CPU path). Importing torch here just to read nothing would drag CUDA
    initialisation into a watermark read.
    """
    import sys

    torch = sys.modules.get("torch")
    if (
        torch is None
        or not torch.cuda.is_available()
        or not torch.cuda.is_initialized()
    ):
        return {
            "allocated_bytes": None,
            "reserved_bytes": None,
            "max_allocated_bytes": None,
            "by_device": {},
        }
    alloc = reserved = peak = 0
    by_device: Dict[str, int] = {}
    for i in range(torch.cuda.device_count()):
        a = int(torch.cuda.memory_allocated(i))
        alloc += a
        reserved += int(torch.cuda.memory_reserved(i))
        peak = max(peak, int(torch.cuda.max_memory_allocated(i)))
        by_device[f"cuda:{i}"] = a
    return {
        "allocated_bytes": alloc,
        "reserved_bytes": reserved,
        "max_allocated_bytes": peak,
        "by_device": by_device,
    }


def _dispatch_device(args, kwargs):
    """The device an entry point's dispatch runs on: its ``device=``
    keyword, else its first tensor argument's, else the entry points'
    default (cuda when there is one)."""
    import torch

    dev = kwargs.get("device")
    if dev is not None:
        return torch.device(dev)
    found = _first_tensor(args)
    if found is not None:
        return found.device
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _first_tensor(x, depth: int = 0):
    import torch

    if isinstance(x, torch.Tensor):
        return x
    if depth > 3:
        return None
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            t = _first_tensor(v, depth + 1)
            if t is not None:
                return t
    return None


def device_bytes(x, dev) -> int:
    """Bytes of the distinct storages of the tensors in ``x`` (containers
    walked a few levels deep) that lie on ``dev``."""
    out: Dict[int, int] = {}
    _device_storages(x, dev, out)
    return sum(out.values())


def _device_storages(x, dev, out: Dict[int, int], depth: int = 0) -> None:
    """{storage address: bytes} of the tensors in ``x`` on ``dev``
    (containers walked a few levels deep; views of one storage counted
    once)."""
    import torch

    if isinstance(x, torch.Tensor):
        d = x.device
        if d.type == dev.type and (dev.index is None or d.index == dev.index):
            st = x.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
        return
    if depth > 4:
        return
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        for v in x:
            _device_storages(v, dev, out, depth + 1)


class MemoryLedger:
    """Process-wide memory ledger (see module docstring).

    One re-entrant lock covers all mutation: the dispatch hook fires from
    every shard-worker thread, the timeline sampler reads watermarks, and
    the first-dispatch analysis claims entries before releasing the lock.
    """

    def __init__(
        self,
        capacity: int = 4096,
        budget_bytes: Optional[int] = None,
        sample_min_interval_s: float = 0.25,
    ):
        if capacity < 2:
            raise ValueError("memory ledger capacity must be >= 2")
        self.capacity = capacity
        # Headroom budget; enable() fills in MemTotal when left None.
        self.budget_bytes = budget_bytes
        # sample() returns the cached record inside this window, so a
        # per-tick caller costs one lock hold, not a device read.
        self.sample_min_interval_s = sample_min_interval_s
        self._lock = make_lock("memory_ledger.entries", kind="rlock")
        self._t0 = time.monotonic()
        # entry -> analysis record (claimed at first Python-side
        # dispatch): {"memory": {...}|None, "flops": None,
        # "bytes_accessed": None, "error": str|None}.
        self.analyses: Dict[str, dict] = {}
        self.analysis_errors = 0
        self.dispatches: Dict[str, int] = {}
        self.samples: "deque[dict]" = deque(maxlen=capacity)
        self.sample_count = 0  # total ever (ring may have evicted)
        self.sample_errors = 0
        self.peak: Dict[str, Optional[int]] = {
            "live_bytes": None,
            "reserved_bytes": None,
            "max_allocated_bytes": None,
            "rss_bytes": None,
            "hwm_bytes": None,
        }
        self._last: Optional[dict] = None
        self._last_t: Optional[float] = None
        # The leak-gate baseline (mark_warm); None until marked.
        self._warm_sample: Optional[dict] = None

    def _fold_peak(self, key: str, v: Optional[int]) -> None:
        if v is not None and (self.peak[key] is None or v > self.peak[key]):
            self.peak[key] = v

    # -- dispatch hook (the compile-ledger registry ride-along) ------------

    def _on_dispatch(self, wrapper, args, kwargs):
        """Per-dispatch hook: count, and model the entry once.

        Steady state (entry already modelled) is one lock hold. The
        analysis runs at most once per entry, on a Python-side dispatch
        outside any graph capture on this thread, never re-entrantly (an
        outer entry's analysis covers the inner entries it calls) and
        never beside another thread's analysis. Returns the callable that
        finishes the analysis after the call, or None.
        """
        entry = wrapper.entry_point
        with self._lock:
            self.dispatches[entry] = self.dispatches.get(entry, 0) + 1
            analyzed = entry in self.analyses
        if analyzed or getattr(_tls, "in_analysis", False):
            return None
        if _cl.capturing():
            return None
        try:
            dev = _dispatch_device(args, kwargs)
        except (TypeError, ValueError, RuntimeError) as e:
            with self._lock:
                self.analyses.setdefault(entry, {
                    "memory": None, "flops": None, "bytes_accessed": None,
                    "error": f"{type(e).__name__}: {e}"[:200]})
                self.analysis_errors += 1
            return None
        if dev.type != "cuda":
            # The CPU path: no device model to record (absent).
            with self._lock:
                self.analyses.setdefault(entry, {
                    "memory": None, "flops": None, "bytes_accessed": None,
                    "error": None})
            return None
        if not _ANALYSIS_LOCK.acquire(blocking=False):
            return None
        with self._lock:
            if entry in self.analyses:
                _ANALYSIS_LOCK.release()
                return None
            rec: dict = {"memory": None, "flops": None, "bytes_accessed": None,
                         "error": None}
            self.analyses[entry] = rec  # claim before releasing the lock
        _tls.in_analysis = True
        try:
            return self._begin_analysis(rec, dev, args, kwargs)
        except BaseException:
            _tls.in_analysis = False
            _ANALYSIS_LOCK.release()
            raise

    def _begin_analysis(self, rec: dict, dev, args, kwargs):
        import torch

        a0 = int(torch.cuda.memory_allocated(dev))
        r0 = int(torch.cuda.memory_reserved(dev))
        with self._lock:
            # The reset below would drop the peak the watermarks report.
            self._fold_peak("max_allocated_bytes",
                            int(torch.cuda.max_memory_allocated(dev)))
        torch.cuda.reset_peak_memory_stats(dev)
        arg_st: Dict[int, int] = {}
        _device_storages(args, dev, arg_st)
        _device_storages(kwargs, dev, arg_st)

        def finish(result) -> None:
            try:
                peak = int(torch.cuda.max_memory_allocated(dev)) - a0
                out_st: Dict[int, int] = {}
                _device_storages(result, dev, out_st)
                out = sum(n for ptr, n in out_st.items() if ptr not in arg_st)
                mem = {key: None for key in MEM_ANALYSIS_FIELDS}
                mem.update(
                    peak_bytes=peak,
                    reserved_bytes=int(torch.cuda.memory_reserved(dev)) - r0,
                    argument_bytes=sum(arg_st.values()),
                    output_bytes=out,
                    temp_bytes=max(0, peak - out),
                )
                with self._lock:
                    rec["memory"] = mem
                    self._fold_peak("max_allocated_bytes", a0 + peak)
            finally:
                _tls.in_analysis = False
                _ANALYSIS_LOCK.release()

        return finish

    def note_plan(self, nbytes: Optional[int]) -> None:
        """A loop plan was built: its static model is the bytes of the
        device buffers it owns (None on the CPU), recorded for the first
        plan; every plan counts as a dispatch of ``PLAN_ENTRY``."""
        with self._lock:
            self.dispatches[PLAN_ENTRY] = self.dispatches.get(PLAN_ENTRY, 0) + 1
            if PLAN_ENTRY in self.analyses:
                return
            mem = None
            if nbytes is not None:
                mem = {key: None for key in MEM_ANALYSIS_FIELDS}
                mem.update(temp_bytes=int(nbytes), peak_bytes=int(nbytes))
            self.analyses[PLAN_ENTRY] = {
                "memory": mem, "flops": None, "bytes_accessed": None,
                "error": None}

    # -- watermark sampling -------------------------------------------------

    def sample(self, force: bool = False) -> dict:
        """One watermark record (throttled; ``force=True`` bypasses).

        Inside the throttle window the CACHED record returns (its
        ``fresh`` key False) so per-tick callers can attach-or-skip
        without a second device read; so does a call while a graph
        capture is open on this thread. Failures are counted, never
        raised: the serving path outranks its own observability.
        """
        now = time.monotonic()
        with self._lock:
            if self._last is not None and (
                _cl.capturing()
                or (not force
                    and now - self._last_t < self.sample_min_interval_s)
            ):
                cached = dict(self._last)
                cached["fresh"] = False
                return cached
        try:
            dm = device_memory()
        except RuntimeError:
            with self._lock:
                self.sample_errors += 1
            dm = {"allocated_bytes": None, "reserved_bytes": None,
                  "max_allocated_bytes": None, "by_device": {}}
        status = read_proc_status()
        rec: dict = {
            "t": round(now - self._t0, 6),
            "live_bytes": dm["allocated_bytes"],
            "live_count": None,
            "reserved_bytes": dm["reserved_bytes"],
            "max_allocated_bytes": dm["max_allocated_bytes"],
            "rss_bytes": status["rss_bytes"],
            "hwm_bytes": status["hwm_bytes"],
        }
        if dm["by_device"]:
            rec["by_platform"] = dict(sorted(dm["by_device"].items()))
        with self._lock:
            self.sample_count += 1
            self.samples.append(rec)
            self._last = rec
            self._last_t = now
            for key in ("live_bytes", "reserved_bytes", "max_allocated_bytes",
                        "rss_bytes", "hwm_bytes"):
                self._fold_peak(key, rec[key])
        out = dict(rec)
        out["fresh"] = True
        return out

    def mark_warm(self) -> dict:
        """Pin the leak-gate baseline: the warm serving path's allocated
        bytes must stay flat from here on. Returns the baseline sample."""
        rec = self.sample(force=True)
        rec.pop("fresh", None)
        with self._lock:
            self._warm_sample = rec
        return dict(rec)

    def note_structural(self) -> None:
        """A problem-identity change legitimately re-allocates (new
        layouts, new warm-state shapes): re-pin the leak baseline IF one
        was already marked. Growth ACROSS a structural boundary is
        provisioning; growth BETWEEN them is a leak — which is exactly
        the warm-path contract (drift/spec/spec_near ticks allocate
        nothing persistent). Before ``mark_warm`` this is a no-op: the
        cold warmup phase owns its own boundary."""
        with self._lock:
            marked = self._warm_sample is not None
        if marked:
            self.mark_warm()

    def leak_report(self, tolerance_bytes: int = 0) -> Optional[dict]:
        """The leak gate's verdict vs the ``mark_warm`` baseline; None
        until the baseline is marked or while allocated bytes are
        unreadable (the CPU). ``flat`` is the contract: no net growth of
        the allocator's allocated bytes across the warm serving path."""
        with self._lock:
            base = self._warm_sample
            last = self._last
        if base is None or last is None:
            return None
        b, l = base.get("live_bytes"), last.get("live_bytes")
        if b is None or l is None:
            return None
        growth = int(l) - int(b)
        return {
            "baseline_bytes": int(b),
            "last_bytes": int(l),
            "growth_bytes": growth,
            "tolerance_bytes": int(tolerance_bytes),
            "flat": growth <= tolerance_bytes,
        }

    def headroom_bytes(self, max_age_s: float = 1.0) -> Optional[float]:
        """budget - RSS; None without a budget or a readable RSS.

        Uses the cached sample when fresh enough, else ONE cheap /proc
        read (~0.1 ms, no device read) — cheap enough for the gateway's
        per-ingest degrade check.
        """
        if self.budget_bytes is None:
            return None
        rss = None
        now = time.monotonic()
        with self._lock:
            if (
                self._last is not None
                and self._last_t is not None
                and now - self._last_t <= max_age_s
            ):
                rss = self._last.get("rss_bytes")
        if rss is None:
            rss = read_proc_status()["rss_bytes"]
        if rss is None:
            return None
        return float(self.budget_bytes - rss)

    # -- the read side -------------------------------------------------------

    def timeline_series(self) -> Dict[str, float]:
        """The ledger's ``mem.*`` timeline emission — ONE definition
        shared by ``Scheduler.timeline_sample`` and
        ``Gateway.timeline_sample`` (the compile ledger's convention, so
        the two serving shapes' series cannot drift). These are GAUGES:
        an unavailable value is ABSENT, never zero — a zero RSS would be
        a lie, unlike the counter-baseline case that zero-fills.
        Sampling is throttled, so a sampler outpacing the throttle
        re-emits the cached watermark (windows stay populated)."""
        rec = self.sample()
        out: Dict[str, float] = {}
        for key in ("live_bytes", "reserved_bytes", "max_allocated_bytes"):
            if rec.get(key) is not None:
                out[f"mem.{key}"] = float(rec[key])
        for platform, nbytes in (rec.get("by_platform") or {}).items():
            out[f"mem.live_bytes.{platform}"] = float(nbytes)
        if rec.get("rss_bytes") is not None:
            out["mem.rss_bytes"] = float(rec["rss_bytes"])
        if rec.get("hwm_bytes") is not None:
            out["mem.hwm_bytes"] = float(rec["hwm_bytes"])
        headroom = self.headroom_bytes()
        if headroom is not None:
            out["mem.headroom_bytes"] = headroom
        return out

    def counters(self) -> dict:
        with self._lock:
            return {
                "mem_entries_analyzed": len(self.analyses),
                "mem_analysis_errors": self.analysis_errors,
                "mem_samples": self.sample_count,
                "mem_sample_errors": self.sample_errors,
                "mem_dispatches": sum(self.dispatches.values()),
            }

    def summary(self) -> dict:
        """Per-entry table + watermarks + leak verdict, JSON-able."""
        with self._lock:
            entries = {}
            names = sorted(set(self.analyses) | set(self.dispatches))
            for name in names:
                rec = self.analyses.get(name)
                e: dict = {"dispatches": self.dispatches.get(name, 0)}
                if rec is not None:
                    e["memory"] = (
                        dict(rec["memory"]) if rec["memory"] else None
                    )
                    e["flops"] = rec["flops"]
                    e["bytes_accessed"] = rec["bytes_accessed"]
                    if rec["error"]:
                        e["error"] = rec["error"]
                entries[name] = e
            watermarks = {
                "peak_live_bytes": self.peak["live_bytes"],
                "peak_reserved_bytes": self.peak["reserved_bytes"],
                "peak_max_allocated_bytes": self.peak["max_allocated_bytes"],
                "peak_rss_bytes": self.peak["rss_bytes"],
                "peak_hwm_bytes": self.peak["hwm_bytes"],
                "samples": self.sample_count,
                "sample_errors": self.sample_errors,
            }
        return {
            "entries": entries,
            "watermarks": watermarks,
            "leak": self.leak_report(),
            "budget_bytes": self.budget_bytes,
            "counters": self.counters(),
        }

    def dump(self) -> dict:
        """One JSON-able blob: header + watermark sample list."""
        with self._lock:
            samples = [dict(s) for s in self.samples]
        return {
            "header": {
                "memory_ledger": 1,
                "capacity": self.capacity,
                "budget_bytes": self.budget_bytes,
                "summary": self.summary(),
            },
            "samples": samples,
        }

    def to_jsonl(self) -> str:
        return memory_to_jsonl(self.dump())

    def dump_jsonl(self, path) -> None:
        from pathlib import Path

        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(self.to_jsonl(), encoding="utf-8")


# -- process-wide enable/disable ---------------------------------------------


def _on_dispatch(wrapper, args, kwargs):
    led = _LEDGER
    if led is None:
        return None
    return led._on_dispatch(wrapper, args, kwargs)


def note_plan(nbytes: Optional[int]) -> None:
    """A loop plan was built (``solver.device_loop``): record its owned
    device bytes on the process ledger, if one is enabled."""
    led = _LEDGER
    if led is not None:
        led.note_plan(nbytes)


def enable(ledger: Optional[MemoryLedger] = None, **kwargs) -> MemoryLedger:
    """Install ``ledger`` (or a fresh one from ``kwargs``) as THE process
    memory ledger and register the dispatch hook on the compile ledger's
    entry-point registry. The hook stays registered across
    disable/enable cycles and is dormant (one module-global read) while
    no ledger is current. A budget left None resolves to MemTotal."""
    global _LEDGER
    led = ledger if ledger is not None else MemoryLedger(**kwargs)
    if led.budget_bytes is None:
        # /proc read stays OUTSIDE the lock: enable() is rare, but the
        # ledger lock is on the dispatch path and must never wait on I/O.
        led.budget_bytes = read_meminfo_total()
    with _LEDGER_LOCK:
        _cl.set_dispatch_hook(_on_dispatch)
        _LEDGER = led
        return led


def disable() -> Optional[MemoryLedger]:
    """Detach the process memory ledger (hook goes dormant); returns it.
    Every test/CLI owner must call this in a finally — a leaked global
    ledger would model (and watermark) other tests' dispatches, exactly
    like a leaked compile ledger would mint counters."""
    global _LEDGER
    with _LEDGER_LOCK:
        led, _LEDGER = _LEDGER, None
        return led


def current() -> Optional[MemoryLedger]:
    return _LEDGER


# -- persistence + report (the flight-recorder JSONL convention) -------------


def memory_to_jsonl(dump: dict) -> str:
    """Header line + one watermark sample per line; pure function of the
    dump, so ``to_jsonl(from_jsonl(s)) == s`` byte-for-byte."""
    lines = [json.dumps(dump["header"], sort_keys=True)]
    for rec in dump["samples"]:
        lines.append(json.dumps(rec, sort_keys=True))
    return "\n".join(lines) + "\n"


def memory_from_jsonl(text: str) -> dict:
    """Parse a dumped memory ledger back into the ``dump()`` shape."""
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError("empty memory-ledger dump")
    header = json.loads(lines[0])
    if not isinstance(header, dict) or "memory_ledger" not in header:
        raise ValueError("memory-ledger dump missing its header line")
    if header["memory_ledger"] != 1:
        raise ValueError(
            f"unknown memory-ledger dump version {header['memory_ledger']!r}"
        )
    return {
        "header": header,
        "samples": [json.loads(ln) for ln in lines[1:]],
    }


def _fmt_bytes(v: Optional[int]) -> str:
    """Deterministic human-scale bytes: exact value, MB alongside."""
    if v is None:
        return "n/a"
    return f"{v} ({v / 1e6:.2f} MB)"


def render_report(dump: dict) -> str:
    """Deterministic text over a ``dump()``/``memory_from_jsonl`` blob:
    watermarks, leak verdict, per-entry static model (bytes + FLOPs per
    dispatch). No clocks, no live reads — byte-identical on every replay
    of the same dump (the ``solver memory --check`` contract)."""
    summary = dump["header"].get("summary", {})
    entries = summary.get("entries", {})
    marks = summary.get("watermarks", {})
    leak = summary.get("leak")
    out: List[str] = []
    out.append("memory ledger")
    budget = summary.get("budget_bytes")
    out.append(f"  headroom budget: {_fmt_bytes(budget)}")
    out.append(
        "  watermarks: peak_live={} peak_rss={} peak_hwm={} "
        "(samples={}, errors={})".format(
            _fmt_bytes(marks.get("peak_live_bytes")),
            _fmt_bytes(marks.get("peak_rss_bytes")),
            _fmt_bytes(marks.get("peak_hwm_bytes")),
            marks.get("samples", 0),
            marks.get("sample_errors", 0),
        )
    )
    if leak is None:
        out.append("  leak gate: not marked (no warm baseline)")
    else:
        out.append(
            "  leak gate: {} — baseline={} last={} growth={:+d} B".format(
                "FLAT" if leak["flat"] else "GREW",
                _fmt_bytes(leak["baseline_bytes"]),
                _fmt_bytes(leak["last_bytes"]),
                leak["growth_bytes"],
            )
        )
    out.append("")
    out.append(
        f"  {'entry point':<34s} {'disp':>7s} {'temp MB':>9s} "
        f"{'args MB':>9s} {'out MB':>8s} {'code MB':>8s} {'flops':>12s}"
    )
    for name in sorted(entries):
        e = entries[name]
        mem = e.get("memory")

        def _mb(key: str) -> str:
            if not mem or mem.get(key) is None:
                return "n/a"
            return f"{mem[key] / 1e6:.2f}"

        flops = e.get("flops")
        out.append(
            f"  {name:<34s} {e.get('dispatches', 0):>7d} "
            f"{_mb('temp_bytes'):>9s} {_mb('argument_bytes'):>9s} "
            f"{_mb('output_bytes'):>8s} {_mb('generated_code_bytes'):>8s} "
            f"{(f'{flops:.3g}' if flops is not None else 'n/a'):>12s}"
        )
        if e.get("error"):
            out.append(f"  {'':<34s} ! {e['error']}")
    unanalyzed = [
        n for n, e in sorted(entries.items())
        if "memory" in e and e["memory"] is None and not e.get("error")
    ]
    if unanalyzed:
        out.append("")
        out.append(
            "  no static model (backend reported none): "
            + ", ".join(unanalyzed)
        )
    return "\n".join(out) + "\n"
