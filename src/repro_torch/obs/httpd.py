"""Stdlib HTTP exposition endpoint: ``/metrics`` + ``/healthz`` (port of
`repro/obs/httpd.py`; stdlib only, only this docstring differs).

A tiny `ThreadingHTTPServer` on a daemon thread — zero dependencies, built
for a Prometheus scraper (or ``curl``) to pull the monitor's self-telemetry
while the fleet runs. Content is rendered *per request* from callables, so
a scrape always sees the current registry state, not a stale file.

    server = MetricsServer(render_metrics=registry.render, port=0)
    server.start()
    ...  # GET http://127.0.0.1:{server.port}/metrics
    server.stop()

``port=0`` binds an ephemeral port (read it back from ``server.port``) —
what the tests and the fleet demo use so parallel runs never collide.
"""
from __future__ import annotations

import http.server
import json
import threading
import time
from typing import Callable, Dict, Optional, Tuple

CONTENT_TYPE_EXPOSITION = "text/plain; version=0.0.4; charset=utf-8"


class MetricsServer:
    def __init__(self, render_metrics: Callable[[], str],
                 host: str = "127.0.0.1", port: int = 9464,
                 health: Optional[Callable[[], Dict[str, object]]] = None,
                 extra_routes: Optional[
                     Dict[str, Callable[[], Tuple[str, str]]]] = None):
        self._render_metrics = render_metrics
        self._health = health
        self._extra = dict(extra_routes or {})
        self._t0 = time.time()
        self._server: Optional[http.server.ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.host = host
        self.requested_port = int(port)
        self.port: Optional[int] = None
        self.scrapes = 0  # /metrics requests served

    # -- routes ---------------------------------------------------------------
    def _healthz(self) -> Tuple[str, str]:
        payload: Dict[str, object] = {
            "status": "ok",
            "uptime_s": round(time.time() - self._t0, 3),
            "scrapes": self.scrapes,
        }
        if self._health is not None:
            try:
                payload.update(self._health())
            except Exception as e:  # health detail must not kill the probe
                payload["detail_error"] = repr(e)
        return "application/json", json.dumps(payload) + "\n"

    def _route(self, path: str) -> Optional[Tuple[str, str]]:
        if path == "/metrics":
            self.scrapes += 1
            return CONTENT_TYPE_EXPOSITION, self._render_metrics()
        if path == "/healthz":
            return self._healthz()
        if path in self._extra:
            return self._extra[path]()
        return None

    # -- lifecycle ------------------------------------------------------------
    def start(self) -> "MetricsServer":
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                path = self.path.split("?", 1)[0]
                try:
                    route = outer._route(path)
                except Exception as e:
                    self.send_error(500, explain=repr(e))
                    return
                if route is None:
                    self.send_error(404)
                    return
                ctype, body = route
                data = body.encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):  # silence per-request stderr spam
                pass

        self._server = http.server.ThreadingHTTPServer(
            (self.host, self.requested_port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="eacgm-metrics-http",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
