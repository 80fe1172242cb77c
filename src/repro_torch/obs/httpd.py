"""Live scrape endpoint: ``/metrics``, ``/healthz`` and ``/costs.json``.

Own copy of ``repro.obs.httpd``.  A serve with ``--metrics-port`` answers
Prometheus scrapes *while it runs* instead of only dumping snapshots at exit.  The server is the
stdlib :class:`~http.server.ThreadingHTTPServer` on a daemon thread —
no framework, no new dependency — and every handler reads the same
sources the offline CLI reads, so a live scrape and a post-hoc
``python -m repro_torch.obs`` report can never disagree about schema:

* ``GET /metrics`` — :func:`~repro_torch.obs.export.prometheus_text` over a
  merged :class:`~repro_torch.obs.metrics.MetricRegistry`: every registered
  snapshot provider (the process registry, each replica's telemetry)
  plus any ``metrics-*.json`` snapshots already in the trace dir.
* ``GET /healthz`` — the health plane's worst state as an HTTP status
  (``ok``→200, ``warn``→429, ``page``→503) with the full report as the
  JSON body, so a load balancer and a human read the same probe.
* ``GET /costs.json`` — :func:`~repro_torch.obs.costs.cost_report` over the
  provenance ledger in the trace dir (404 until the first record
  lands, or when the serve is untraced).

Handlers never raise into the serve loop: any exception becomes a 500
on that one response.  Binding port 0 picks a free port; ``start()``
returns the real one.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from .export import prometheus_text, read_metrics
from .metrics import MetricRegistry

__all__ = ["MetricsServer", "HEALTH_STATUS"]

# worst health state -> HTTP status. 429 for warn (still serving, shed
# load), 503 for page (take it out of rotation).
HEALTH_STATUS = {"ok": 200, "warn": 429, "page": 503}


class MetricsServer:
    """Threaded HTTP endpoint over live registries + an optional trace dir.

    ``snapshot_providers`` are zero-arg callables returning registry
    snapshot docs (:meth:`MetricRegistry.snapshot`) — called fresh on
    every scrape so counters are live, not start-of-serve copies.
    ``health_provider`` returns a health-plane report dict with a
    ``"state"`` key; ``None`` means no health plane (always 200 ok).
    """

    def __init__(self, *, port: int = 0, host: str = "127.0.0.1",
                 snapshot_providers: list[Callable[[], dict]] | None = None,
                 health_provider: Callable[[], dict] | None = None,
                 trace_dir: str | None = None) -> None:
        self.snapshot_providers = list(snapshot_providers or [])
        self.health_provider = health_provider
        self.trace_dir = trace_dir
        self._host, self._port = host, port
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- responses
    def metrics_text(self) -> str:
        reg = MetricRegistry.from_snapshots(
            p() for p in self.snapshot_providers)
        if self.trace_dir is not None:
            reg.merge(read_metrics(self.trace_dir).snapshot())
        return prometheus_text(reg)

    def health_doc(self) -> tuple[int, dict]:
        if self.health_provider is None:
            return 200, {"state": "ok"}
        doc = self.health_provider()
        return HEALTH_STATUS.get(doc.get("state"), 500), doc

    def costs_doc(self) -> dict | None:
        if self.trace_dir is None:
            return None
        from .costs import cost_report
        from .provenance import read_ledger

        records = read_ledger(self.trace_dir)
        if not records:
            return None
        return cost_report(records)

    # --------------------------------------------------------------- control
    def start(self) -> int:
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args) -> None:   # keep the serve log clean
                pass

            def _send(self, status: int, body: bytes,
                      ctype: str) -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:   # noqa: N802 (http.server API)
                try:
                    path = self.path.split("?", 1)[0]
                    if path == "/metrics":
                        self._send(200, server.metrics_text().encode(),
                                   "text/plain; version=0.0.4")
                    elif path == "/healthz":
                        status, doc = server.health_doc()
                        self._send(status, (json.dumps(doc) + "\n").encode(),
                                   "application/json")
                    elif path == "/costs.json":
                        doc = server.costs_doc()
                        if doc is None:
                            self._send(404, b'{"error": "no ledger"}\n',
                                       "application/json")
                        else:
                            self._send(200,
                                       (json.dumps(doc) + "\n").encode(),
                                       "application/json")
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:   # a scrape bug must not kill a serve
                    try:
                        self._send(500, f"{type(e).__name__}: {e}\n".encode(),
                                   "text/plain")
                    except OSError:
                        pass             # client went away mid-response

        self._httpd = ThreadingHTTPServer((self._host, self._port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="repro-metrics-httpd",
                                        daemon=True)
        self._thread.start()
        self._port = self._httpd.server_address[1]
        return self._port

    @property
    def port(self) -> int:
        return self._port

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
