"""Detailed-metrics database: sqlite recorder + dashboard queries.

The port of ``pathway_tpu/web_dashboard/db.py`` (reference:
python/pathway/web_dashboard/db.py) — the engine writes a
``metrics_<run>.db`` sqlite file under ``PATHWAY_DETAILED_METRICS_DIR`` and
the dashboard app reads the newest one.  Same three tables (Metrics,
MetricsAgg, Resources), stdlib ``sqlite3`` instead of SQLModel.

Recording is host-side bookkeeping off the device path: a sampler thread
reads operator counters (ints) between commits and never touches a device
tensor, so it cannot add a device sync.  ``pw.run`` starts a recorder when
``PATHWAY_DETAILED_METRICS_DIR`` is set; the processes of one spawned
cluster share a database file (``worker_id`` is a column).
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
import uuid

_SCHEMA = """
CREATE TABLE IF NOT EXISTS Metrics (
    timestamp INTEGER, worker_id INTEGER, operator_id INTEGER,
    name TEXT, value REAL,
    PRIMARY KEY (timestamp, worker_id, operator_id, name)
);
CREATE TABLE IF NOT EXISTS MetricsAgg (
    timestamp INTEGER, worker_id INTEGER, operator_id INTEGER,
    latency_ms REAL, rows_positive INTEGER, rows_negative INTEGER,
    PRIMARY KEY (timestamp, worker_id, operator_id)
);
CREATE TABLE IF NOT EXISTS Resources (
    run_id TEXT PRIMARY KEY, graph TEXT, resources TEXT
);
"""


def _default_run_id() -> str:
    # all workers of one spawned cluster must share a db file (the dashboard
    # reads the newest file only; worker_id is a column, not a file) — the
    # supervisor's per-run fabric secret is the shared run identity
    secret = os.environ.get("PATHWAY_FABRIC_SECRET")
    if secret:
        import hashlib

        return hashlib.sha1(secret.encode()).hexdigest()[:12]
    return uuid.uuid4().hex[:12]


def create_db(path: str) -> sqlite3.Connection:
    conn = sqlite3.connect(path, check_same_thread=False)
    conn.executescript(_SCHEMA)
    conn.execute("PRAGMA journal_mode=WAL;")
    conn.execute("PRAGMA synchronous=NORMAL;")
    return conn


def _process_memory_bytes() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except OSError:
        pass
    return 0.0


class MetricsRecorder:
    """Samples per-operator counters from a live scheduler into sqlite.

    Derived metrics per sampling window: ``operator.latency`` (ms spent in
    the operator's callbacks), ``operator.rows`` in/out deltas, and
    ``process.memory.usage``; MetricsAgg rows mirror the reference's
    aggregate table for the dashboard's "latest" view.
    """

    def __init__(self, scheduler, directory: str, *, interval_s: float = 1.0,
                 worker_id: int = 0, run_id: str | None = None,
                 graph: dict | None = None):
        os.makedirs(directory, exist_ok=True)
        self.run_id = run_id or _default_run_id()
        self.path = os.path.join(directory, f"metrics_{self.run_id}.db")
        self.scheduler = scheduler
        self.worker_id = worker_id
        self.interval_s = interval_s
        self._conn = create_db(self.path)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # op -> (rows_in, rows_out, busy_s, rows_out_neg) at last sample
        self._last: dict[int, tuple[int, int, float, int]] = {}
        if graph is not None:
            self.record_graph(graph)

    def record_graph(self, graph: dict, resources: dict | None = None) -> None:
        self._conn.execute(
            "INSERT OR REPLACE INTO Resources (run_id, graph, resources) "
            "VALUES (?, ?, ?)",
            (self.run_id, json.dumps(graph), json.dumps(resources or {})),
        )
        self._conn.commit()

    def sample(self) -> None:
        ts = int(time.time() * 1000)
        rows_m: list[tuple] = []
        rows_a: list[tuple] = []
        for op in self.scheduler.operators:
            prev = self._last.get(op.id, (0, 0, 0.0, 0))
            d_out = op.rows_out - prev[1]
            d_busy_ms = (op.busy_s - prev[2]) * 1e3
            d_neg = op.rows_out_neg - prev[3]
            self._last[op.id] = (op.rows_in, op.rows_out, op.busy_s,
                                 op.rows_out_neg)
            rows_m += [
                (ts, self.worker_id, op.id, "operator.latency", d_busy_ms),
                (ts, self.worker_id, op.id, "operator.rows_in", float(op.rows_in)),
                (ts, self.worker_id, op.id, "operator.rows_out", float(op.rows_out)),
            ]
            rows_a.append((
                ts, self.worker_id, op.id, d_busy_ms, d_out - d_neg, d_neg,
            ))
        rows_m.append(
            (ts, self.worker_id, -1, "process.memory.usage", _process_memory_bytes())
        )
        with self._conn:
            self._conn.executemany(
                "INSERT OR REPLACE INTO Metrics VALUES (?, ?, ?, ?, ?)", rows_m
            )
            self._conn.executemany(
                "INSERT OR REPLACE INTO MetricsAgg VALUES (?, ?, ?, ?, ?, ?)", rows_a
            )

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.sample()
                except sqlite3.Error:
                    pass

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
        try:
            self.sample()  # final snapshot
        except sqlite3.Error:
            pass
        self._conn.close()


# -- dashboard read side (reference: db.py get_* functions) -----------------

def latest_db(directory: str) -> str | None:
    paths = [
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.startswith("metrics_") and f.endswith(".db")
    ] if os.path.isdir(directory) else []
    return max(paths, key=os.path.getmtime) if paths else None


def connect_ro(path: str) -> sqlite3.Connection:
    conn = sqlite3.connect(f"file:{path}?mode=ro", uri=True,
                           check_same_thread=False)
    conn.row_factory = sqlite3.Row
    return conn


def get_latest_data(conn: sqlite3.Connection) -> list[dict]:
    max_ts = conn.execute("SELECT MAX(timestamp) FROM Metrics").fetchone()[0]
    if max_ts is None:
        return []
    rows = conn.execute(
        "SELECT * FROM MetricsAgg WHERE timestamp = ?", (max_ts,)
    ).fetchall()
    return [dict(r) for r in rows]


def get_available_range(conn: sqlite3.Connection) -> dict:
    lo, hi = conn.execute(
        "SELECT MIN(timestamp), MAX(timestamp) FROM Metrics"
    ).fetchone()
    if lo is None or hi is None:
        return {"min": None, "max": None}
    return {"min": round(lo / 1000) * 1000, "max": round(hi / 1000) * 1000}


def get_metrics_at(conn: sqlite3.Connection, timestamp: int) -> list[dict]:
    max_ts = conn.execute(
        "SELECT MAX(timestamp) FROM Metrics WHERE timestamp < ?", (timestamp,)
    ).fetchone()[0]
    if not max_ts:
        return []
    rows = conn.execute(
        "SELECT * FROM MetricsAgg WHERE timestamp = ?", (max_ts,)
    ).fetchall()
    return [dict(r) for r in rows]


def get_graph(conn: sqlite3.Connection) -> dict | None:
    row = conn.execute("SELECT graph FROM Resources LIMIT 1").fetchone()
    return json.loads(row[0]) if row and row[0] else None


def get_charts_data(conn: sqlite3.Connection) -> list[dict]:
    rows = conn.execute(
        """
        SELECT l.timestamp AS timestamp, l.max_latency AS max_latency,
               m.memory AS memory
        FROM (SELECT timestamp, MAX(value) AS max_latency FROM Metrics
              WHERE name = 'operator.latency' GROUP BY timestamp) l
        JOIN (SELECT timestamp, MAX(value) AS memory FROM Metrics
              WHERE name = 'process.memory.usage' GROUP BY timestamp) m
          ON l.timestamp = m.timestamp
        """
    ).fetchall()
    return [dict(r) for r in rows]
