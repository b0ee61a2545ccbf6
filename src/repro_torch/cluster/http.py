"""Stdlib-only streaming HTTP front end over a ``ServeCluster`` (the port
of ``repro.cluster.http``).  No framework:
``http.server.ThreadingHTTPServer`` plus hand-rolled chunked transfer
encoding, so the only dependency is the standard library.

  * ``POST /generate`` -- body ``{"tokens": [...], "max_new_tokens": N}``;
    response is ``Transfer-Encoding: chunked`` NDJSON, one line per
    delivered token (``{"token": t, "i": k}``), ``{"reset": true}`` on a
    recompute preemption (previously streamed tokens re-emit), and a
    final ``{"done": true, "tokens": [...], "replica": r}`` line.
  * ``GET /healthz`` -- ``{"ok": true, "replicas": N, "admissible": M}``.
  * ``GET /stats`` -- the router's world view: one ``ReplicaStats`` dict
    per replica plus the active policy.
  * ``GET /metrics`` -- Prometheus text exposition: the router's
    registry plus every replica's forwarded snapshot, labelled
    ``{replica=...,role=...}``.
  * ``GET /trace[?n=N]`` -- Chrome/Perfetto ``trace_event`` JSON of the
    last N events (default: everything the rings hold), router and all
    replicas merged on one timeline.
"""

from __future__ import annotations

import json
import queue
import threading
from dataclasses import asdict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Optional, Tuple
from urllib.parse import parse_qs, urlparse


def _make_handler(cluster):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):           # noqa: D102 -- quiet tests
            pass

        # ------------------------------------------------------- helpers
        def _json(self, code: int, obj: Any) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _chunk(self, data: bytes) -> None:
            self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
            self.wfile.flush()

        def _line(self, obj: Any) -> None:
            self._chunk(json.dumps(obj).encode() + b"\n")

        def _text(self, code: int, text: str,
                  ctype: str = "text/plain; version=0.0.4") -> None:
            data = text.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        # ---------------------------------------------------------- GETs
        def do_GET(self):                       # noqa: N802
            url = urlparse(self.path)
            if url.path == "/healthz":
                stats = cluster.stats()
                self._json(200, {
                    "ok": True,
                    "replicas": len(stats),
                    "admissible": sum(1 for s in stats if not s.drained),
                })
            elif url.path == "/stats":
                self._json(200, {
                    "policy": cluster.router.policy,
                    "replicas": [asdict(s) for s in cluster.stats()],
                })
            elif url.path == "/metrics":
                self._text(200, cluster.prometheus())
            elif url.path == "/trace":
                qs = parse_qs(url.query)
                last = None
                try:
                    last = int(qs["n"][0]) if "n" in qs else None
                except ValueError:
                    self._json(400, {"error": "n must be an integer"})
                    return
                self._json(200, {
                    "traceEvents": cluster.trace_events(last),
                    "displayTimeUnit": "ms",
                })
            else:
                self._json(404, {"error": f"no route {self.path}"})

        # --------------------------------------------------------- POSTs
        def do_POST(self):                      # noqa: N802
            if self.path != "/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                tokens = [int(t) for t in body["tokens"]]
                max_new = int(body.get("max_new_tokens", 16))
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            events: "queue.Queue[Tuple[str, Any]]" = queue.Queue()
            cr = cluster.submit(
                tokens, max_new_tokens=max_new,
                on_token=lambda i, tok: events.put(("token", (i, tok))))
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            while True:
                try:
                    kind, payload = events.get(timeout=0.05)
                except queue.Empty:
                    if cr.done():
                        break
                    continue
                i, tok = payload
                self._line({"reset": True} if tok is None
                           else {"token": int(tok), "i": int(i)})
            try:
                out = cr.result(timeout=60.0)
                self._line({"done": True, "tokens": out,
                            "replica": cr.replica})
            except Exception as e:              # noqa: BLE001
                self._line({"error": f"{type(e).__name__}: {e}"})
            self._chunk(b"")                    # terminal 0-length chunk

    return Handler


class ClusterServer:
    """The serving front end: bind, serve on a daemon thread, close."""

    def __init__(self, cluster, host: str = "127.0.0.1", port: int = 0):
        self.cluster = cluster
        self.httpd = ThreadingHTTPServer((host, port),
                                         _make_handler(cluster))
        self.httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> Tuple[str, int]:
        return self.httpd.server_address[:2]

    def start(self) -> "ClusterServer":
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        name="cluster-http", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)
