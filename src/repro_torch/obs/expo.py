"""Metric exposition: a tiny stdlib HTTP endpoint + snapshot helpers; the
port's copy of ``repro.obs.expo``.

``MetricsServer`` owns a ``ThreadingHTTPServer`` on a daemon thread —
no web framework, no new dependency — and serves:

  * ``GET /metrics``       — Prometheus text format 0.0.4;
  * ``GET /metrics.json``  — JSON (alias ``/snapshot``): ``{"metrics":
    <registry snapshot>, "stats": <extra() if wired>}``, plus the
    runtime's ``stats()`` (controller decision history, queue depths)
    when the server is owned by a ``ServingRuntime``;
  * ``GET /traces``        — the recent-span ring as JSON
    (``?n=32`` limits to the newest n);
  * ``GET /healthz``       — liveness (200 "ok").

It binds ``127.0.0.1`` unless told otherwise; ``port=0`` binds an
ephemeral port (tests), and ``.port``/``.url`` report the bound address.
The handler reads the registry under its lock (a consistent scrape) and
never logs per-request lines — scrapes every few seconds must not spam
the serving process's stderr.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from .metrics import MetricsRegistry
from .trace import TraceBuffer

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def json_snapshot(registry: MetricsRegistry,
                  extra: Optional[Callable[[], dict]] = None) -> dict:
    """The /metrics.json payload (also callable without a server)."""
    out = {"metrics": registry.snapshot()}
    if extra is not None:
        out["stats"] = extra()
    return out


class MetricsServer:
    """Scrape endpoint over one registry (+ optional trace ring and
    extra-stats callable).  Start with ``start()``; idempotent
    ``close()`` shuts the socket and joins the thread."""

    def __init__(self, registry: MetricsRegistry, *,
                 traces: Optional[TraceBuffer] = None,
                 extra: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        self.traces = traces
        self.extra = extra
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):          # noqa: N802 — stdlib name
                pass                            # scrapes must not spam

            def _send(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):                   # noqa: N802 — stdlib name
                url = urlparse(self.path)
                try:
                    if url.path == "/metrics":
                        self._send(200,
                                   server.registry.prometheus().encode(),
                                   PROMETHEUS_CONTENT_TYPE)
                    elif url.path in ("/metrics.json", "/snapshot"):
                        body = json.dumps(
                            json_snapshot(server.registry, server.extra),
                            indent=1, default=str).encode()
                        self._send(200, body, "application/json")
                    elif url.path == "/traces":
                        q = parse_qs(url.query)
                        n = int(q["n"][0]) if "n" in q else None
                        ring = server.traces
                        body = (ring.to_json(n) if ring is not None
                                else "[]").encode()
                        self._send(200, body, "application/json")
                    elif url.path == "/healthz":
                        self._send(200, b"ok", "text/plain")
                    else:
                        self._send(404, b"not found: try /metrics, "
                                   b"/metrics.json, /traces, /healthz",
                                   "text/plain")
                except Exception as e:          # noqa: BLE001 — a scrape
                    # failure must never kill the serving process
                    self._send(500, repr(e).encode(), "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host = self._httpd.server_address[0]
        return f"http://{host}:{self.port}"

    def start(self) -> "MetricsServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="repro-metrics",
                daemon=True)
            self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:
            # shutdown() waits for serve_forever to return: only when the
            # thread runs it, or close() before start() would hang
            self._httpd.shutdown()
            self._thread.join(timeout=5.0)
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()
