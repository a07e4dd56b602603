"""The HTTP status endpoint: stdlib ``http.server``, zero new deps.

A :class:`TelemetryServer` wraps one :class:`~.registry.Telemetry` and
serves, on a daemon thread:

* ``GET /``                    — the self-contained live dashboard (HTML);
* ``GET /metrics``             — full JSON snapshot;
* ``GET /metrics?format=prom`` — Prometheus text exposition;
* ``GET /jobs`` / ``GET /nodes`` — the snapshot's job/node sections;
* ``GET /events?since=N``      — ring events after cursor ``N`` (JSON,
  with ``next`` = the cursor to pass on the following poll);
* ``GET /events/stream``       — Server-Sent Events: pushes each new bus
  event (``event: bus``) as it lands plus periodic full snapshots
  (``event: snapshot``), so the dashboard renders on change instead of
  polling; ``?since=N`` resumes from a cursor;
* anything else                — 404; a malformed query (``since=x``) — 400.

Read-only by construction: every route is a snapshot read, no handler
mutates cluster state, so exposing it beside a live dispatcher is safe.
``ThreadingHTTPServer`` keeps a slow scraper from blocking the dashboard
poll; handlers touch only the thread-safe registry.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from repro_torch.cluster.telemetry.dashboard import DASHBOARD_HTML
from repro_torch.cluster.telemetry.registry import Telemetry

__all__ = ["TelemetryServer"]


class TelemetryServer:
    """Serve one registry over HTTP (see module docstring).

    ``port=0`` binds an ephemeral port (tests); the chosen one is in
    ``.port`` / ``.url`` after construction.  ``close()`` is idempotent
    and joins the serving thread.
    """

    def __init__(self, telemetry: Telemetry, *, host: str = "127.0.0.1",
                 port: int = 0):
        self.telemetry = telemetry
        # Set on close(): open /events/stream loops watch it so shutdown
        # is not held hostage by long-lived SSE connections.
        self._stop = threading.Event()
        handler = _make_handler(telemetry, self._stop)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="telemetry-http",
            kwargs={"poll_interval": 0.2}, daemon=True,
        )
        self._thread.start()
        self._closed = False

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._httpd.shutdown()
        self._thread.join(timeout=5.0)
        self._httpd.server_close()


def _make_handler(telemetry: Telemetry, stop: threading.Event) -> type:
    # SSE pacing: how often the stream loop wakes to check for new bus
    # events, and how long between unconditional full-snapshot frames
    # (gauges move without emitting events — pool sizes, queue depth).
    SSE_POLL_S = 0.25
    SSE_SNAPSHOT_EVERY_S = 3.0

    class Handler(BaseHTTPRequestHandler):
        # The endpoint must never spam the host process's stderr.
        def log_message(self, fmt: str, *args) -> None:  # pragma: no cover
            pass

        def _reply(self, status: int, body: bytes,
                   content_type: str) -> None:
            self.send_response(status)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def _json(self, obj, status: int = 200) -> None:
            body = json.dumps(obj, default=str, indent=1).encode("utf-8")
            self._reply(status, body, "application/json; charset=utf-8")

        def _sse_frame(self, event: str, obj) -> None:
            body = json.dumps(obj, default=str, separators=(",", ":"))
            self.wfile.write(
                f"event: {event}\ndata: {body}\n\n".encode("utf-8"))
            self.wfile.flush()

        def _stream(self, since: int) -> None:
            """Server-Sent Events loop: one ``snapshot`` frame up front,
            then ``bus`` frames as ring events land, with a fresh
            ``snapshot`` on activity or at least every few seconds (gauges
            move without emitting events).  Runs on this connection's
            thread until the client disconnects or the server closes.
            """
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-store")
            self.send_header("Connection", "close")
            self.end_headers()
            cursor = since
            self._sse_frame("snapshot", telemetry.snapshot())
            last_snap = time.monotonic()
            while not stop.is_set():
                events = telemetry.events_since(cursor)
                for ev in events:
                    self._sse_frame("bus", ev)
                    cursor = ev["seq"]
                now = time.monotonic()
                if events or now - last_snap >= SSE_SNAPSHOT_EVERY_S:
                    self._sse_frame("snapshot", telemetry.snapshot())
                    last_snap = now
                stop.wait(SSE_POLL_S)

        def do_GET(self) -> None:  # noqa: N802 (stdlib naming)
            try:
                split = urlsplit(self.path)
                path = split.path.rstrip("/") or "/"
                query = parse_qs(split.query)
                if path == "/":
                    self._reply(200, DASHBOARD_HTML.encode("utf-8"),
                                "text/html; charset=utf-8")
                elif path == "/metrics":
                    fmt = (query.get("format") or ["json"])[0]
                    if fmt == "prom":
                        self._reply(
                            200, telemetry.prometheus().encode("utf-8"),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif fmt == "json":
                        self._json(telemetry.snapshot())
                    else:
                        self._json(
                            {"error": f"unknown format {fmt!r} "
                                      "(expected json or prom)"},
                            status=400,
                        )
                elif path == "/jobs":
                    self._json({"jobs": telemetry.snapshot()["jobs"]})
                elif path == "/nodes":
                    self._json({"nodes": telemetry.snapshot()["nodes"]})
                elif path == "/events/stream":
                    try:
                        since = int((query.get("since") or ["0"])[0])
                    except ValueError:
                        self._json({"error": "since must be an integer"},
                                   status=400)
                        return
                    self._stream(since)
                elif path == "/events":
                    try:
                        since = int((query.get("since") or ["0"])[0])
                        limit = int((query.get("limit") or ["500"])[0])
                    except ValueError:
                        self._json(
                            {"error": "since/limit must be integers"},
                            status=400,
                        )
                        return
                    events = telemetry.events_since(since, limit)
                    next_cursor = events[-1]["seq"] if events else since
                    self._json({"events": events, "next": next_cursor})
                else:
                    self._json({"error": f"no such route {path!r}"},
                               status=404)
            except (BrokenPipeError, ConnectionResetError):
                pass  # scraper went away mid-reply; nothing to clean up

    return Handler
