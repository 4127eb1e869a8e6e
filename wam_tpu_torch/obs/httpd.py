"""Optional stdlib-http ``/metrics`` endpoint for the obs registry
(PyTorch port of `wam_tpu.obs.httpd`).

`start_metrics_server(port)` spins up a `ThreadingHTTPServer` on a daemon
thread serving `registry.render_prom()` at ``GET /metrics`` (anything
else 404s). Port 0 binds an ephemeral port — the returned server's
``server_port`` tells you which; `FleetServer(prom_port=...)` and
``bench_serve --prom-port`` use this. No dependencies beyond the stdlib:
this is deliberately NOT a prometheus_client integration, just the text
exposition over the simplest possible server.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from wam_tpu_torch.obs.registry import registry

__all__ = ["start_metrics_server", "stop_metrics_server"]


class _MetricsHandler(BaseHTTPRequestHandler):
    def do_GET(self):
        if self.path.rstrip("/") not in ("/metrics", ""):
            self.send_error(404)
            return
        body = registry.render_prom().encode("utf-8")
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # keep scrape noise off stderr
        pass


def start_metrics_server(port: int, host: str = "127.0.0.1"):
    """Serve ``/metrics`` on ``host:port`` from a daemon thread. Returns
    the `ThreadingHTTPServer` (read ``.server_port``; call
    `stop_metrics_server` or ``.shutdown()`` to stop)."""
    server = ThreadingHTTPServer((host, port), _MetricsHandler)
    server.daemon_threads = True
    t = threading.Thread(target=server.serve_forever,
                         name="obs-metrics-http", daemon=True)
    t.start()
    server._obs_thread = t
    return server


def stop_metrics_server(server) -> None:
    server.shutdown()
    server.server_close()
    t = getattr(server, "_obs_thread", None)
    if t is not None:
        t.join(timeout=5)
