"""Web dashboard app over the detailed-metrics database.

The port of ``pathway_tpu/web_dashboard/dashboard.py`` (reference:
python/pathway/web_dashboard/dashboard.py) — a served app reading
the newest ``metrics_*.db`` under ``PATHWAY_DETAILED_METRICS_DIR`` with the
endpoints /metrics/latest, /metrics/available_range, /metrics/at/{ts},
/graph, /metrics/charts and a static frontend.  Stdlib server (the
dashboard is control-plane: request volume is human-scale).

Run it with ``python -m pathway_tpu_torch dashboard --metrics-dir . --port 8866``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import db as _db

_FRONTEND = os.path.join(os.path.dirname(__file__), "frontend")


class DashboardServer:
    def __init__(self, metrics_dir: str = ".", host: str = "0.0.0.0",
                 port: int = 8866, *, wait_for_db: bool = True,
                 retry_s: float = 10.0):
        self.metrics_dir = metrics_dir
        self.host = host
        self.port = port
        self.wait_for_db = wait_for_db
        self.retry_s = retry_s
        self._conn = None
        self._db_path: str | None = None
        self._server: ThreadingHTTPServer | None = None

    def _ensure_conn(self):
        latest = _db.latest_db(self.metrics_dir)
        while latest is None and self.wait_for_db:
            print(f"No metrics database found in {self.metrics_dir!r}. "
                  f"Retrying in {self.retry_s:.0f}s...", file=sys.stderr)
            time.sleep(self.retry_s)
            latest = _db.latest_db(self.metrics_dir)
        if latest is None:
            raise FileNotFoundError(f"no metrics_*.db in {self.metrics_dir!r}")
        if latest != self._db_path:
            if self._conn is not None:
                self._conn.close()
            self._conn = _db.connect_ro(latest)
            self._db_path = latest
        return self._conn

    # -- endpoint bodies ---------------------------------------------------
    def handle(self, path: str):
        """Returns (status, body_bytes, content_type) for GET `path`."""
        if path.split("?", 1)[0] == "/debug/trace":
            # flight-recorder dump: spans recorded in THIS
            # process (a dashboard embedded in a serving process shows
            # its timeline; the standalone app shows its own requests)
            from urllib.parse import parse_qsl

            from .. import obs

            body = obs.chrome_trace_dump(
                dict(parse_qsl(path.partition("?")[2]))
            ).encode()
            return 200, body, "application/json"
        if path.split("?", 1)[0] == "/debug/profile":
            # device cost observatory: this process's per-program
            # compile/FLOPs/dispatch/roofline table
            from urllib.parse import parse_qsl

            from ..obs import profiler

            body = profiler.profile_dump(
                dict(parse_qsl(path.partition("?")[2]))
            ).encode()
            return 200, body, "application/json"
        if path.split("?", 1)[0] == "/fleet":
            # replica serving front: per-replica load,
            # affinity hit rate, suspended sessions + resume p99 from
            # THIS process's fleet/session-tier registries
            from ..serve import metrics as serve_metrics

            data = {
                "fleets": [
                    s.snapshot() for s in serve_metrics.all_fleet_stats()
                ],
                # constant-memory state caches (SSD decode
                # tier) — slots in use, per-seq bytes, suspend/resume
                # counters, next to the kv table
                "states": [
                    s.snapshot() for s in serve_metrics.all_state_stats()
                ],
                "stores": [],
            }
            for store in serve_metrics.all_session_stores():
                try:
                    snap = store.stats()
                except Exception:
                    continue
                snap["name"] = store.name
                data["stores"].append(snap)
            return 200, json.dumps(data).encode(), "application/json"
        if path.startswith("/metrics/") or path == "/graph":
            conn = self._ensure_conn()
            if path == "/metrics/latest":
                data = _db.get_latest_data(conn)
            elif path == "/metrics/available_range":
                data = _db.get_available_range(conn)
            elif path == "/metrics/charts":
                data = _db.get_charts_data(conn)
            elif path.startswith("/metrics/at/"):
                try:
                    ts = int(path.rsplit("/", 1)[1])
                except ValueError:
                    return 400, b'{"error": "bad timestamp"}', "application/json"
                data = _db.get_metrics_at(conn, ts)
            elif path == "/graph":
                data = _db.get_graph(conn)
            else:
                return 404, b'{"error": "no such route"}', "application/json"
            return 200, json.dumps(data).encode(), "application/json"
        # static frontend — containment via commonpath on resolved paths:
        # a bare startswith(_FRONTEND) also admits sibling dirs sharing
        # the prefix (frontend_private/) and symlink escapes
        name = "index.html" if path in ("", "/") else path.lstrip("/")
        root = os.path.realpath(_FRONTEND)
        fpath = os.path.realpath(os.path.join(root, name))
        try:
            contained = os.path.commonpath([root, fpath]) == root
        except ValueError:
            contained = False
        if not contained or not os.path.isfile(fpath):
            return 404, b"not found", "text/plain"
        ctype = "text/html" if fpath.endswith(".html") else (
            "text/javascript" if fpath.endswith(".js") else "text/css"
            if fpath.endswith(".css") else "application/octet-stream")
        with open(fpath, "rb") as f:
            return 200, f.read(), ctype

    # -- serving -----------------------------------------------------------
    def start(self) -> None:
        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                try:
                    code, body, ctype = app.handle(self.path.split("?")[0])
                except FileNotFoundError as exc:
                    code, body, ctype = 503, str(exc).encode(), "text/plain"
                except Exception as exc:
                    code, body, ctype = 500, str(exc).encode(), "text/plain"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Access-Control-Allow-Origin", "*")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def serve_forever(self) -> None:
        self.start()
        try:
            threading.Event().wait()
        except KeyboardInterrupt:
            pass

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server = None


def main(argv: list[str] | None = None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="pathway-tpu dashboard")
    p.add_argument("--metrics-dir",
                   default=os.environ.get("PATHWAY_DETAILED_METRICS_DIR", "."))
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8866)
    args = p.parse_args(argv)
    DashboardServer(args.metrics_dir, args.host, args.port).serve_forever()
    return 0
