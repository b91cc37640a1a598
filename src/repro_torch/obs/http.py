"""Tiny threaded metrics endpoint for ``launch/serve.py --metrics-port``.

Serves two read-only views of one :class:`~repro_torch.obs.metrics.MetricsRegistry`:

    GET /metrics        Prometheus text exposition
    GET /metrics.json   JSON snapshot (same doc as ``registry.snapshot()``)
    GET /healthz        liveness JSON from the server's ``health``
                        callable — 200 for ok/degraded, 503 for crashed
                        (the load balancer's eject signal)

stdlib only (``http.server`` on a daemon thread) — a scrape every few
seconds reads registry state under its per-metric locks and never touches
the serving hot path.  Port 0 binds an ephemeral port (tests); the bound
port is on ``MetricsServer.port``.  ``set_health`` may attach the health
callable after boot (serve.py binds the port before the engine exists so
scrapers can poll from t=0; until then /healthz reports ``booting``).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .metrics import MetricsRegistry


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = None  # set per-server via subclassing
    server_ref = None                 # the owning MetricsServer

    def do_GET(self):  # noqa: N802 (http.server API)
        status = 200
        if self.path.split("?")[0] == "/metrics":
            body = self.registry.to_prometheus().encode("utf-8")
            ctype = "text/plain; version=0.0.4; charset=utf-8"
        elif self.path.split("?")[0] == "/metrics.json":
            body = json.dumps(self.registry.snapshot(), sort_keys=True,
                              default=float).encode("utf-8")
            ctype = "application/json"
        elif self.path.split("?")[0] == "/healthz":
            health = getattr(self.server_ref, "health", None)
            doc = {"status": "booting"} if health is None else health()
            status = 503 if doc.get("status") == "crashed" else 200
            body = json.dumps(doc, sort_keys=True,
                              default=float).encode("utf-8")
            ctype = "application/json"
        else:
            self.send_error(404)
            return
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class MetricsServer:
    """Background scrape endpoint bound to ``host:port`` (port 0 = pick)."""

    def __init__(self, registry: MetricsRegistry, port: int,
                 host: str = "127.0.0.1", health=None):
        self.health = health          # () -> dict, e.g. engine.health
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": registry, "server_ref": self})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-http",
            daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def set_health(self, fn) -> None:
        """Attach (or swap) the /healthz source after boot."""
        self.health = fn

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def serve_metrics(registry: MetricsRegistry, port: int,
                  host: str = "127.0.0.1", health=None) -> MetricsServer:
    return MetricsServer(registry, port, host=host, health=health)
