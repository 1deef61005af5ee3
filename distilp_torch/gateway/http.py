"""Minimal HTTP/1.1 JSON API over the gateway (stdlib asyncio only).

The port's copy of ``distilp_tpu/gateway/http.py``.

Five routes:

    POST /events                 {"fleet": <id>, "event": {<sched.events>}}
                                 -> 200 {"view": {...}} after the shard
                                 ticks (the response IS the placement), OR
                                 429 + Retry-After when admission control
                                 sheds the event (bounded worker queue
                                 full; see README "Overload & admission
                                 control")
    GET  /placement/<fleet_id>   -> 200 {"view": {...}} (latest, no solve)
    GET  /healthz                -> 200/503 per-shard health + overall
    GET  /metrics                -> 200 gateway metrics snapshot (JSON), OR
                                 Prometheus v0.0.4 text when the client
                                 content-negotiates it (``Accept:
                                 text/plain`` or ``?format=prom``) — the
                                 labeled per-shard exposition
    GET  /debug/flight/<fleet>   -> 200 the fleet's live flight-recorder
                                 ring (404 unless serving with a recorder)
    GET  /slo                    -> 200 live SLO status: per-objective
                                 budget, per-window burn rates, open
                                 alerts (404 unless serving with --slo)
    GET  /signals                -> 200 the versioned autoscaling payload
                                 (obs.slo.SignalsPayload: per-worker
                                 queue depth + trend, burn rates,
                                 headroom vs max-sustainable-eps; 404
                                 unless a metrics timeline is attached —
                                 serve --slo or --timeline-dir; the
                                 burn-rate block needs --slo)

One connection = one request (``Connection: close``): the serving tier's
clients are schedulers and probes, not browsers, and the parser stays ~50
lines. The asyncio loop only ever PARSES and ROUTES — every blocking step
(shard ticks, worker round trips) happens on the shard workers' threads,
reached through ``handle_event_async``'s future bridge or the default
executor, so one slow fleet's solve never stalls another fleet's ingest.
That invariant is mechanically enforced: dlint DLP018 forbids blocking
calls inside ``async def`` bodies in this package.

Tracing: with a tracer on the gateway, every POST /events gets an
``http.request`` root span whose context rides into ``handle_event_async``
as the explicit parent — so a traced event's tree starts at HTTP parse,
not at ingest.
"""

from __future__ import annotations

import asyncio
import json
from math import ceil
from typing import Optional, Tuple

from ..obs.trace import now_ms
from .gateway import Gateway, QueueFull, view_to_dict
from .procworker import WorkerCrashed

_MAX_BODY = 8 * 1024 * 1024  # a DeviceJoin carries a full profile; 8 MB is generous
_MAX_HEADER_LINES = 64
_JSON = "application/json"
# The exposition content type the Prometheus scraper expects.
_PROM = "text/plain; version=0.0.4; charset=utf-8"


def _response(
    status: int,
    payload,
    content_type: str = _JSON,
    extra_headers: Optional[dict] = None,
) -> bytes:
    if isinstance(payload, (dict, list)):
        body = json.dumps(payload).encode()
    elif isinstance(payload, bytes):
        body = payload
    else:
        body = str(payload).encode()
    reason = {
        200: "OK", 400: "Bad Request", 404: "Not Found",
        405: "Method Not Allowed", 409: "Conflict", 413: "Payload Too Large",
        429: "Too Many Requests",
        500: "Internal Server Error", 503: "Service Unavailable",
    }.get(status, "OK")
    extras = "".join(
        f"{k}: {v}\r\n" for k, v in (extra_headers or {}).items()
    )
    head = (
        f"HTTP/1.1 {status} {reason}\r\n"
        f"Content-Type: {content_type}\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"{extras}"
        f"Connection: close\r\n\r\n"
    )
    return head.encode() + body


class GatewayHTTPServer:
    """asyncio HTTP front end for one ``Gateway``."""

    def __init__(self, gateway: Gateway, host: str = "127.0.0.1", port: int = 0):
        self.gateway = gateway
        self.host = host
        self.port = port  # 0 = ephemeral; replaced by the bound port
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        async with self._server:
            await self._server.serve_forever()

    async def close(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- request handling --------------------------------------------------

    async def _handle_conn(self, reader, writer) -> None:
        ctype = _JSON
        headers = None
        try:
            status, payload, ctype = await self._dispatch(reader)
        except QueueFull as e:
            # Load shed at the admission gate (bounded worker queue full).
            # The 429 contract: a parseable integer Retry-After header
            # (RFC delta-seconds, ceiling of the gateway's drain
            # estimate) plus the precise float in the JSON body. The shed
            # itself was already counted and flight-recorded inside the
            # gateway before the exception reached this tier.
            self.gateway.metrics.inc("http_too_many_requests")
            status, payload = 429, {
                "error": str(e),
                "fleet": e.fleet_id,
                "depth": e.depth,
                "retry_after_s": e.retry_after_s,
            }
            headers = {"Retry-After": str(max(1, ceil(e.retry_after_s)))}
        except (EOFError, ConnectionError) as e:
            # IncompleteReadError (an EOFError) = the client closed before
            # its advertised body arrived: a client fault, not a server
            # one — it must not inflate the internal-error signal.
            self.gateway.metrics.inc("http_client_gone")
            status, payload = 400, {"error": f"{type(e).__name__}: {e}"}
        except (ValueError, json.JSONDecodeError) as e:
            self.gateway.metrics.inc("http_bad_request")
            status, payload = 400, {"error": f"{type(e).__name__}: {e}"}
        except (KeyError, FileNotFoundError) as e:
            self.gateway.metrics.inc("http_not_found")
            status, payload = 404, {"error": str(e)}
        except WorkerCrashed as e:
            # A child died under this request and the supervised retry
            # budget (read-only RPCs retry once against the respawn;
            # mutating calls never retry) is spent. 503, not 500: the
            # gateway itself is fine, the shard is mid-recovery — the
            # client should back off and retry.
            self.gateway.metrics.inc("http_worker_crashed")
            status, payload = 503, {
                "error": str(e),
                "worker": e.worker_id,
                "op": e.op,
            }
            headers = {"Retry-After": "1"}
        except RuntimeError as e:
            # e.g. "no placement published yet" — the shard exists but has
            # nothing servable; a retriable condition, not a client error.
            self.gateway.metrics.inc("http_conflict")
            status, payload = 409, {"error": str(e)}
        except Exception as e:
            self.gateway.metrics.inc("http_internal_error")
            status, payload = 500, {"error": f"{type(e).__name__}: {e}"}
        try:
            writer.write(_response(status, payload, ctype, headers))
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            self.gateway.metrics.inc("http_client_gone")
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                self.gateway.metrics.inc("http_client_gone")

    async def _read_request(self, reader) -> Tuple[str, str, bytes, str]:
        request_line = (await reader.readline()).decode("latin-1").strip()
        if not request_line:
            raise ValueError("empty request")
        parts = request_line.split()
        if len(parts) != 3:
            raise ValueError(f"malformed request line {request_line!r}")
        method, target, _version = parts
        content_length = 0
        accept = ""
        for _ in range(_MAX_HEADER_LINES):
            line = (await reader.readline()).decode("latin-1")
            if line in ("\r\n", "\n", ""):
                break
            name, _, value = line.partition(":")
            name = name.strip().lower()
            if name == "content-length":
                content_length = int(value.strip())
            elif name == "accept":
                accept = value.strip().lower()
        else:
            raise ValueError("too many header lines")
        if content_length > _MAX_BODY:
            raise ValueError(f"body exceeds {_MAX_BODY} bytes")
        body = (
            await reader.readexactly(content_length) if content_length else b""
        )
        return method, target, body, accept

    async def _dispatch(self, reader) -> Tuple[int, object, str]:
        t_req = now_ms()  # request arrival: the http.request span starts HERE
        method, target, body, accept = await self._read_request(reader)
        loop = asyncio.get_running_loop()
        path, _, query = target.partition("?")
        if method == "POST" and path == "/events":
            data = json.loads(body or b"{}")
            fleet_id = data.get("fleet")
            if not fleet_id:
                raise ValueError("POST /events needs a 'fleet' field")
            if "event" not in data:
                raise ValueError("POST /events needs an 'event' object")
            from ..sched.events import event_from_dict

            event = event_from_dict(data["event"])
            # The trace root for an HTTP-ingested event: parse+route+wait
            # +tick all under one request span (explicit parent — the loop
            # thread is shared, ambient context would cross coroutines).
            # Backdated to request arrival so header/body reads and the
            # JSON/event parse — which all happened above — are INSIDE the
            # span: "HTTP parse?" is one of the questions a trace answers.
            span = self.gateway.tracer.start_span(
                "http.request", parent=None,
                attrs={"method": method, "target": path, "fleet": fleet_id},
            )
            if self.gateway.tracer.enabled:
                span.t0_ms = t_req  # the shared NOOP span has no slots
            try:
                view = await self.gateway.handle_event_async(
                    fleet_id, event, parent=span.context()
                )
            finally:
                span.end()
            return 200, {"fleet": fleet_id, "view": view_to_dict(view)}, _JSON
        if method == "GET" and path.startswith("/placement/"):
            fleet_id = path[len("/placement/"):]
            # latest() blocks on a worker round trip; off the loop thread.
            view = await loop.run_in_executor(
                None, self.gateway.latest, fleet_id
            )
            return 200, {"fleet": fleet_id, "view": view_to_dict(view)}, _JSON
        if method == "GET" and path == "/healthz":
            health = await loop.run_in_executor(None, self.gateway.healthz)
            return (503 if health["status"] == "broken" else 200), health, _JSON
        if method == "GET" and path == "/metrics":
            # Content negotiation: Prometheus scrapers say `Accept:
            # text/plain` (or force it with ?format=prom) and get the
            # labeled v0.0.4 text exposition; everyone else keeps the
            # JSON snapshot — the pre-obs default, byte-compatible.
            if "format=prom" in query or "text/plain" in accept:
                text = await loop.run_in_executor(
                    None, self.gateway.prometheus_text
                )
                return 200, text, _PROM
            snap = await loop.run_in_executor(
                None, self.gateway.metrics_snapshot
            )
            return 200, snap, _JSON
        if method == "GET" and path == "/slo":
            status = await loop.run_in_executor(None, self.gateway.slo_status)
            return 200, status, _JSON
        if method == "GET" and path == "/signals":
            signals = await loop.run_in_executor(None, self.gateway.signals)
            return 200, signals, _JSON
        if method == "GET" and path == "/control":
            status = await loop.run_in_executor(
                None, self.gateway.control_status
            )
            return 200, status, _JSON
        if method == "GET" and path.startswith("/debug/flight/"):
            fleet_id = path[len("/debug/flight/"):]
            records = await loop.run_in_executor(
                None, self.gateway.flight_snapshot, fleet_id
            )
            return 200, {"fleet": fleet_id, "records": records}, _JSON
        if method not in ("GET", "POST"):
            return 405, {"error": f"method {method} not supported"}, _JSON
        return 404, {"error": f"no route for {method} {target}"}, _JSON
