"""Thin HTTP shim over the serve protocol.

``POST /`` with one protocol request object as the JSON body returns the
reply as the JSON response body — the same validation, admission, and
isolation as the socket path, because every request still goes through
``AnalysisService.handle``. Overload semantics ride standard HTTP: an
``overloaded`` shed maps to 429 with a ``Retry-After`` header (rounded
up from the reply's ``retry_after_ms``), ``shutting_down`` to 503.
``GET /healthz`` answers a metrics summary (uptime, request counters,
queue depths, autoscaler state, warm buckets, frontier telemetry
rollup), ``GET /status`` the full status rollup, and ``GET /metrics``
Prometheus text exposition (observe/export.py) — all without touching
the engine, so a scrape during a long analyze never blocks. This is deliberately a shim, not a web framework:
stdlib ``http.server`` only, one process, no TLS — put a real proxy in
front if this ever leaves localhost.

The port's copy of mythril_tpu/serve/http_shim.py.
"""

from __future__ import annotations

import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import protocol

log = logging.getLogger(__name__)

#: matches the protocol's per-line bound; requests beyond it are 413
MAX_BODY_BYTES = protocol.MAX_LINE_BYTES


class _Handler(BaseHTTPRequestHandler):
    service = None  # injected by serve_http via type()

    def log_message(self, fmt, *args):  # route access logs to logging
        log.debug("http: " + fmt, *args)

    def _reply(self, status: int, payload: dict,
               retry_after_s: Optional[int] = None) -> None:
        body = json.dumps(payload, sort_keys=True).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after_s is not None:
            self.send_header("Retry-After", str(retry_after_s))
        self.end_headers()
        self.wfile.write(body)

    def _reply_text(self, status: int, body: str,
                    content_type: str) -> None:
        payload = body.encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self):
        if self.path == "/healthz":
            reply = self.service.handle(
                protocol.Request("healthz", "healthz", {}))
            self._reply(200, reply)
            return
        if self.path == "/status":
            reply = self.service.handle(
                protocol.Request("status", "status", {}))
            self._reply(200, reply)
            return
        if self.path == "/metrics":
            # Prometheus scrape: text exposition, not a JSON envelope
            reply = self.service.handle(
                protocol.Request("metrics", "metrics", {}))
            self._reply_text(200, reply["exposition"],
                             reply["content_type"])
            return
        self._reply(404, protocol.error_reply(
            None, "bad_request",
            "GET supports /healthz, /status, and /metrics"))

    def do_POST(self):
        try:
            length = int(self.headers.get("Content-Length", "0"))
        except ValueError:
            length = -1
        if length < 0:
            self._reply(411, protocol.error_reply(
                None, "bad_request", "Content-Length required"))
            return
        if length > MAX_BODY_BYTES:
            self._reply(413, protocol.error_reply(
                None, "line_too_long",
                f"body exceeds {MAX_BODY_BYTES} bytes"))
            return
        body = self.rfile.read(length)
        try:
            request = protocol.parse_request(body)
        except protocol.ProtocolError as error:
            self._reply(400, protocol.error_reply(
                error.request_id, error.code, error.message))
            return
        reply = self.service.handle(request)
        retry_after_s: Optional[int] = None
        if reply.get("ok"):
            status = 200
        elif reply["error"]["code"] == "busy":
            status = 429  # Too Many Requests: back off and retry
        elif reply["error"]["code"] == "overloaded":
            status = 429  # shed by admission control
            retry_ms = reply["error"].get("retry_after_ms")
            if isinstance(retry_ms, (int, float)) and retry_ms > 0:
                # Retry-After is whole seconds; round up so a client
                # honoring the header never retries early
                retry_after_s = max(1, -(-int(retry_ms) // 1000))
        elif reply["error"]["code"] == "shutting_down":
            status = 503  # draining: this daemon is going away
        elif reply["error"]["code"] == "quarantined":
            status = 409  # Conflict: the resource itself is refused
        else:
            status = 400
        self._reply(status, reply, retry_after_s=retry_after_s)


def serve_http(service, host: str = "127.0.0.1", port: int = 8551,
               ready_event=None) -> int:
    """Serve HTTP until a ``shutdown`` request drains the service.
    Returns the bound port (useful with ``port=0`` in tests)."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    server = ThreadingHTTPServer((host, port), handler)
    server.timeout = 0.25
    server.daemon_threads = True
    bound_port = server.server_address[1]
    service.http_port = bound_port  # visible before the loop: port=0
    # callers (tests, supervisors) read the ephemeral port from here
    try:
        service.startup()
        if ready_event is not None:
            ready_event.set()
        log.info("serving HTTP on %s:%d", host, bound_port)
        while not service.shutting_down.is_set():
            server.handle_request()
    except KeyboardInterrupt:
        log.info("interrupted — draining")
    finally:
        service.shutdown()
        server.server_close()
    return bound_port
