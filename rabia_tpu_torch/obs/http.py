"""Stdlib HTTP shim for Prometheus scrapers.

The gateway's admin surface is native framed transport (PROTOCOL_GUIDE
§admin frames) — a Prometheus scraper speaks neither the length-prefix
framing nor the 16-byte id handshake, so this module serves the same
three documents over plain HTTP/1.1 from a daemon thread:

    GET /metrics   text/plain; Prometheus exposition 0.0.4
    GET /healthz   application/json (200 ok / 503 degraded)
    GET /journal   application/json (bounded anomaly journal);
                   filters: ?kind=<anomaly kind>&last=<N>  (default 64)
    GET /timeline  application/json (per-second telemetry ring,
                   obs/telemetry); filter: ?last=<N> samples

Zero dependencies beyond ``http.server``; binds an ephemeral port by
default. Request handling calls back into registry/health providers —
both are snapshot-style reads designed to be safe from a foreign thread
(torn in-between values read as metrics noise, never corruption).

The port's copy of the reference's ``rabia_tpu/obs/http.py``, its imports
retargeted to ``rabia_tpu_torch``.
"""

from __future__ import annotations

import json
import logging
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from rabia_tpu_torch.obs.journal import AnomalyJournal
from rabia_tpu_torch.obs.registry import MetricsRegistry

logger = logging.getLogger("rabia_tpu_torch.obs.http")


class AdminHTTPServer:
    """Serve /metrics, /healthz and /journal for one replica component."""

    def __init__(
        self,
        registry: MetricsRegistry,
        health_fn: Optional[Callable[[], dict]] = None,
        journal: Optional[AnomalyJournal] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        timeline_fn: Optional[Callable[[Optional[int]], dict]] = None,
    ) -> None:
        self.registry = registry
        self.health_fn = health_fn
        self.journal = journal
        self.timeline_fn = timeline_fn
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet: logger, not stderr
                logger.debug("admin http: " + fmt, *args)

            def do_GET(self):  # noqa: N802 - BaseHTTPRequestHandler API
                path, _, qs = self.path.partition("?")
                try:
                    if path == "/metrics":
                        body = outer.registry.render_prometheus().encode()
                        ctype = "text/plain; version=0.0.4; charset=utf-8"
                        code = 200
                    elif path == "/healthz":
                        doc = (
                            outer.health_fn()
                            if outer.health_fn is not None
                            else {"status": "ok"}
                        )
                        code = 200 if doc.get("status") == "ok" else 503
                        body = json.dumps(doc).encode()
                        ctype = "application/json"
                    elif path == "/journal":
                        q = urllib.parse.parse_qs(qs)
                        kind = q.get("kind", [None])[0]
                        try:
                            last = int(q.get("last", ["64"])[0])
                        except ValueError:
                            last = 64
                        entries = (
                            outer.journal.snapshot(
                                limit=max(0, last), kind=kind
                            )
                            if outer.journal is not None
                            else []
                        )
                        body = json.dumps({"anomalies": entries}).encode()
                        ctype = "application/json"
                        code = 200
                    elif path == "/timeline":
                        q = urllib.parse.parse_qs(qs)
                        try:
                            last = int(q.get("last", [None])[0])  # type: ignore[arg-type]
                        except (TypeError, ValueError):
                            last = None
                        doc = (
                            outer.timeline_fn(last)
                            if outer.timeline_fn is not None
                            else {"version": 1, "samples": []}
                        )
                        body = json.dumps(doc).encode()
                        ctype = "application/json"
                        code = 200
                    else:
                        body, ctype, code = b"not found\n", "text/plain", 404
                except Exception as e:  # a broken provider must answer 500
                    logger.exception("admin http handler failed")
                    body = f"internal error: {e}\n".encode()
                    ctype, code = "text/plain", 500
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self.host = host
        self.port = int(self._srv.server_address[1])
        self._thread = threading.Thread(
            target=self._srv.serve_forever,
            kwargs={"poll_interval": 0.2},
            daemon=True,
            name="rabia-admin-http",
        )
        self._thread.start()

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        self._thread.join(timeout=2.0)
