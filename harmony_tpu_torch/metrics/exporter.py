"""Per-process Prometheus exposition endpoint.

A copy of ``harmony_tpu/metrics/exporter.py`` (pure Python; the port keeps
its own). A scraper reaches every process (the JobServer, the pod's
followers) through one dependency-free HTTP server per process serving
``GET /metrics`` in the text format rendered by
:mod:`harmony_tpu_torch.metrics.registry` (plus ``GET /healthz`` for
liveness probes).

Wiring: the long-running entry points call :func:`exporter_from_env` —
``HARMONY_METRICS_PORT`` unset/empty means no exporter (tests and
one-shot CLI commands pay nothing), ``0`` picks a free port (printed /
surfaced via STATUS), a fixed port binds it. A fixed port already taken
(two processes sharing a host) falls back to an ephemeral one rather
than failing the process: a training job must never die for the sake of
its metrics endpoint.
"""
from __future__ import annotations

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from harmony_tpu_torch.metrics.registry import MetricRegistry, get_registry

ENV_PORT = "HARMONY_METRICS_PORT"

#: the content type Prometheus' scraper expects for text exposition
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class MetricsExporter:
    """Tiny threaded HTTP server: /metrics (exposition) + /healthz."""

    def __init__(self, port: int = 0,
                 registry: Optional[MetricRegistry] = None,
                 host: str = "0.0.0.0") -> None:
        self.registry = registry  # None = the live process registry
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self) -> None:
                if self.path.split("?", 1)[0] == "/metrics":
                    reg = exporter.registry or get_registry()
                    body = reg.expose().encode()
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE)
                elif self.path == "/healthz":
                    body = b"ok\n"
                    self.send_response(200)
                    self.send_header("Content-Type", "text/plain")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    def start(self) -> "MetricsExporter":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


def exporter_from_env(
    registry: Optional[MetricRegistry] = None,
) -> Optional[MetricsExporter]:
    """Start an exporter if ``HARMONY_METRICS_PORT`` asks for one.
    Returns the running exporter, or None (knob unset/unparseable).
    A taken fixed port degrades to an ephemeral one — the process's
    metrics stay reachable (STATUS surfaces the bound port) and the
    process never dies for its exporter."""
    spec = os.environ.get(ENV_PORT, "").strip()
    if not spec:
        return None
    try:
        port = int(spec)
    except ValueError:
        return None
    try:
        exporter = MetricsExporter(port, registry=registry)
    except (OSError, OverflowError, ValueError):
        # taken port (OSError) or out-of-range port (bind raises
        # OverflowError, NOT OSError): same contract either way —
        # degrade to an ephemeral port, never die for metrics
        exporter = MetricsExporter(0, registry=registry)
    return exporter.start()
