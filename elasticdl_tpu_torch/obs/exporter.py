"""Observability HTTP exporter of a replica process: the port's copy of
``elasticdl_tpu/obs/exporter.py``.

Serves on ``--metrics_port``:

    /metrics      Prometheus text exposition (0.0.4) of the registry
    /healthz      liveness JSON ({"status": "ok", "uptime_s": ...})
    /journal      last-N journal events as JSON (?n=, bounded tail; no
                  file paths)

``/slo`` and ``/debug/vars`` answer 404 until the SLO plane is ported
(ROADMAP.md Queue 1 item 8).  Every endpoint answers HEAD with headers
only.  Stdlib ``http.server`` only, on named daemon threads; a scrape
reads registry snapshots and never blocks on service locks.  The bound
port is written to ``<dir>/metrics_port`` (``write_port_file``), so
``--metrics_port 0`` is discoverable.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from socketserver import ThreadingMixIn
from typing import Optional

from elasticdl_tpu_torch.common.log_utils import get_logger

logger = get_logger("obs.exporter")

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

#: Discovery file written next to the journal: `--metrics_port 0` binds
#: an ephemeral port, and scrapers/tests read the chosen port from here
#: instead of hardcoding one (the master e2e suites' port-collision
#: flake source).
PORT_FILENAME = "metrics_port"


class _ExporterHTTPServer(ThreadingMixIn, HTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def process_request(self, request, client_address):
        # Override ThreadingMixIn: request threads carry name=/daemon=
        # (thread-hygiene rule — attributable stack dumps, deliberate
        # shutdown semantics).
        thread = threading.Thread(
            target=self.process_request_thread,
            args=(request, client_address),
            name="obs-exporter-request",
            daemon=True,
        )
        thread.start()


class MetricsExporter:
    """One HTTP server over a (registry, journal) pair.  `port=0` binds a
    free port (tests); `start()` returns self so callers can chain."""

    def __init__(
        self,
        registry=None,
        journal=None,
        port: int = 0,
        host: str = "",
        journal_tail: int = 100,
    ):
        if registry is None or journal is None:
            from elasticdl_tpu_torch import obs

            registry = registry or obs.registry()
            journal = journal or obs.journal()
        self._registry = registry
        self._journal = journal
        self._host = host
        self._port = port
        self._journal_tail = journal_tail
        self._server: Optional[_ExporterHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._started_monotonic = 0.0

    @property
    def port(self) -> int:
        return self._port

    def start(self) -> "MetricsExporter":
        self._started_monotonic = time.monotonic()
        exporter = self

        class Handler(BaseHTTPRequestHandler):
            server_version = "elasticdl-obs/1"

            def do_GET(self):  # noqa: N802 — http.server API
                exporter._handle(self)

            def do_HEAD(self):  # noqa: N802 — http.server API
                exporter._handle(self, head=True)

            def log_message(self, format, *args):
                pass  # scrape traffic must not spam the replica log

        self._server = _ExporterHTTPServer(
            (self._host, self._port), Handler
        )
        self._port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="obs-metrics-exporter",
            daemon=True,
        )
        self._thread.start()
        logger.info(
            "Metrics exporter listening on port %d (/metrics, /healthz, /journal)",
            self._port,
        )
        return self

    def write_port_file(self, directory: str) -> Optional[str]:
        """Write the BOUND port to `<directory>/metrics_port` (atomic
        tmp+rename — a reader never sees a torn write).  Returns the
        path, or None when the write failed / the exporter has not
        started; never raises — discovery is observability, not control
        plane."""
        import os
        import tempfile

        if not self._port or not directory:
            return None
        path = os.path.join(directory, PORT_FILENAME)
        tmp_path = None
        try:
            fd, tmp_path = tempfile.mkstemp(
                prefix=PORT_FILENAME + ".", dir=directory
            )
            with os.fdopen(fd, "w") as f:
                f.write(f"{self._port}\n")
            os.replace(tmp_path, path)
        except OSError:
            logger.exception(
                "Could not write metrics-port discovery file in %s",
                directory,
            )
            if tmp_path is not None:
                try:
                    os.unlink(tmp_path)
                except OSError:
                    pass
            return None
        logger.info("Metrics port %d recorded in %s", self._port, path)
        return path

    @staticmethod
    def read_port_file(directory: str) -> Optional[int]:
        """The discovered port (None when absent/garbled) — what tests
        and scrape tooling call instead of hardcoding a port."""
        import os

        try:
            with open(os.path.join(directory, PORT_FILENAME)) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def stop(self):
        if self._server is None:
            return
        self._server.shutdown()
        self._server.server_close()
        self._server = None
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    # ------------------------------------------------------------------

    #: Upper bound on ?n= for /journal: the in-memory ring is itself
    #: bounded, but a hostile/buggy scraper must not size the response.
    JOURNAL_TAIL_MAX = 1000

    def _journal_tail_n(self, query: str) -> int:
        n = self._journal_tail
        for pair in query.split("&"):
            if pair.startswith("n="):
                try:
                    n = int(pair[2:])
                except ValueError:
                    pass
        return max(1, min(n, self.JOURNAL_TAIL_MAX))

    def _handle(self, request: BaseHTTPRequestHandler, head: bool = False):
        path, _, query = request.path.partition("?")
        status = 200
        try:
            if path == "/metrics":
                body = self._registry.render_prometheus().encode("utf-8")
                content_type = PROMETHEUS_CONTENT_TYPE
            elif path == "/healthz":
                body = json.dumps(
                    {
                        "status": "ok",
                        "uptime_s": round(
                            time.monotonic() - self._started_monotonic, 3
                        ),
                    }
                ).encode("utf-8")
                content_type = "application/json"
            elif path == "/journal":
                # Events only, deliberately no journal file path: this
                # endpoint may be exposed beyond the replica's host.
                events = self._journal.tail(self._journal_tail_n(query))
                body = json.dumps(
                    {"events": events, "count": len(events)}, default=str
                ).encode("utf-8")
                content_type = "application/json"
            else:
                status = 404
                # /slo too: the SLO plane is not ported (ROADMAP.md
                # Queue 1 item 8).
                body = b"not found (try /metrics, /healthz, /journal)\n"
                content_type = "text/plain"
        except Exception:
            # A scrape failure is the exporter's bug, never the replica's:
            # answer 500 and keep serving.
            logger.exception("Exporter request %s failed", path)
            try:
                request.send_error(500)
            except OSError:
                pass
            return
        request.send_response(status)
        request.send_header("Content-Type", content_type)
        request.send_header("Content-Length", str(len(body)))
        request.end_headers()
        if not head:
            request.wfile.write(body)
