"""Telemetry: the Prometheus ``/metrics`` endpoint, the run's spans and
their OTLP export, the progress reporter, the workload tracker and the
error log.

The port of ``pathway_tpu/engine/telemetry.py`` (reference:
src/engine/telemetry.rs, OTLP push at :296 and :601, and
src/engine/http_server.rs, the ``/metrics`` server on port 20000).  A
stdlib HTTP server serves per-operator counters from the live scheduler,
the exchange fabric's counters when a cluster runs, and the serving and
device-program lines.  Spans go to ``PATHWAY_TRACE_FILE`` as JSON lines
and, with ``PATHWAY_MONITORING_SERVER`` set, to ``{endpoint}/v1/traces``
as OTLP JSON; ``otlp_export_metrics`` posts the counters to
``{endpoint}/v1/metrics``.  The OpenTelemetry SDK, when importable,
receives the spans as well.

Where the JAX module's ``MetricsServer.start`` returns quietly when its
port is taken (the run goes on without metrics), this one raises: a
caller that asked for the server gets it or an error.  The counters
read here are host integers; nothing here touches a device tensor.
"""

from __future__ import annotations

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

METRICS_PORT = 20000


class MetricsServer:
    def __init__(self, scheduler, port: int = METRICS_PORT):
        self.scheduler = scheduler
        self.port = port
        self._server: ThreadingHTTPServer | None = None
        self.started_at = time.time()

    def render(self) -> str:
        lines = [
            "# TYPE pathway_frontier gauge",
            f"pathway_frontier {self.scheduler.frontier}",
            "# TYPE pathway_uptime_seconds gauge",
            f"pathway_uptime_seconds {time.time() - self.started_at:.1f}",
            "# TYPE pathway_operator_rows_total counter",
        ]
        for op in self.scheduler.operators:
            labels = f'operator="{op.name}",id="{op.id}"'
            lines.append(f"pathway_operator_rows_total{{{labels},direction=\"in\"}} {op.rows_in}")
            lines.append(f"pathway_operator_rows_total{{{labels},direction=\"out\"}} {op.rows_out}")
        lines.append("# TYPE pathway_operator_state_entries gauge")
        for op in self.scheduler.operators:
            size = op.state_size()
            if size:
                labels = f'operator="{op.name}",id="{op.id}"'
                lines.append(
                    f"pathway_operator_state_entries{{{labels}}} {size}"
                )
        fabric = getattr(self, "fabric", None)
        if fabric is not None:
            # exchange-fabric attribution: where cluster wall-time and
            # bytes go (send serialization+write, barrier waits, volumes)
            lines.append("# TYPE pathway_fabric counter")
            for k, v in fabric.stats.items():
                val = f"{v:.6f}" if isinstance(v, float) else str(v)
                lines.append(f'pathway_fabric{{stat="{k}"}} {val}')
        # serving-path backpressure (queue depth, batch occupancy, sheds)
        # shares this surface so one scrape covers dataflow AND serving
        try:
            from ..serve.metrics import render_prometheus_lines

            lines.extend(render_prometheus_lines())
        except Exception:
            pass
        return "\n".join(lines) + "\n"

    def render_dashboard(self) -> str:
        """Minimal live dashboard (reference: python/pathway/web_dashboard/)."""
        rows = "".join(
            f"<tr><td>{op.name}</td><td>{op.id}</td><td>{op.rows_in}</td>"
            f"<td>{op.rows_out}</td></tr>"
            for op in self.scheduler.operators
        )
        serve_html = ""
        try:
            from ..serve.metrics import all_stats

            snaps = [s.snapshot() for s in all_stats()]
        except Exception:
            snaps = []
        if snaps:
            serve_rows = "".join(
                f"<tr><td>{s['name']}</td><td>{s['queue_depth']}</td>"
                f"<td>{s['batch_occupancy_avg']:.2f}</td>"
                f"<td>{s['completed']}</td>"
                f"<td>{sum(s['shed'].values())}</td></tr>"
                for s in snaps
            )
            serve_html = (
                "<h3>serving</h3><table><tr><th>scheduler</th>"
                "<th>queue</th><th>occupancy</th><th>done</th>"
                f"<th>shed</th></tr>{serve_rows}</table>"
            )
        kv_html = ""
        try:
            from ..serve.metrics import all_kv_stats

            kv_snaps = [s.snapshot() for s in all_kv_stats()]
        except Exception:
            kv_snaps = []
        if kv_snaps:
            def _ttft_p50_ms(s):
                recent = sorted(s.get("recent_ttfts") or ())
                if not recent:
                    return "-"
                return f"{recent[len(recent) // 2] * 1e3:.1f}"

            kv_rows = "".join(
                f"<tr><td>{s['name']}</td>"
                f"<td>{s['blocks_in_use']}/{s['blocks_total']}</td>"
                f"<td>{s.get('shards', 1)}&times;"
                f"{s.get('shard_hbm_bytes', 0) / 1e6:.1f}MB</td>"
                f"<td>{s['prefix_hits']}/{s['prefix_hits'] + s['prefix_misses']}</td>"
                f"<td>{s['preemptions']}</td><td>{s['cow_copies']}</td>"
                f"<td>{s['prefix_evictions']}</td>"
                f"<td>{s.get('prefill_chunks', 0)}</td>"
                f"<td>{s.get('mixed_step_occupancy_avg', 0.0):.2f}</td>"
                f"<td>{_ttft_p50_ms(s)}</td>"
                f"<td>{s.get('chain_count', 0)}</td>"
                f"<td>{s.get('chain_occupancy', 0.0):.2f}</td>"
                f"<td>{s.get('host_gap_s', 0.0) * 1e3:.1f}</td>"
                f"<td>{s.get('spec_accepted', 0)}/"
                f"{s.get('spec_proposed', 0)}"
                f" ({s.get('spec_accept_rate', 0.0):.2f})</td></tr>"
                for s in kv_snaps
            )
            kv_html = (
                "<h3>kv cache</h3><table><tr><th>pool</th>"
                "<th>blocks</th><th>tp&times;shard HBM</th>"
                "<th>prefix hit/lookup</th>"
                "<th>preempt</th><th>cow</th><th>evict</th>"
                "<th>chunks</th><th>mixed occ</th>"
                "<th>ttft p50 ms</th><th>chains</th>"
                "<th>chain occ</th><th>host gap ms</th>"
                "<th>spec acc/prop (rate)</th></tr>"
                f"{kv_rows}</table>"
            )
        fabric_html = ""
        fab = getattr(self, "fabric", None)
        if fab is not None:
            st = dict(fab.stats)
            wait_rows = "".join(
                f"<tr><td>{k}</td><td>{st[k]:.3f}s</td></tr>"
                for k in ("compute_s", "wait_marks_s", "agree_min_s",
                          "wait_ctl_s", "wait_sync_s", "send_s", "sender_s")
                if k in st
            )
            fabric_html = (
                "<h3>exchange fabric</h3><table><tr>"
                "<th>sender queue</th><th>peak</th><th>flushes</th>"
                "<th>coalesced</th><th>data out</th><th>bytes out</th>"
                "</tr><tr>"
                f"<td>{st.get('sender_queue_depth', 0)}</td>"
                f"<td>{st.get('sender_queue_peak', 0)}</td>"
                f"<td>{st.get('sender_flushes', 0)}</td>"
                f"<td>{st.get('sender_coalesced', 0)}</td>"
                f"<td>{st.get('data_msgs_out', 0)}</td>"
                f"<td>{st.get('send_bytes', 0)}</td>"
                "</tr></table>"
                f"<table><tr><th>time split</th><th>s</th></tr>{wait_rows}"
                "</table>"
            )
        prog_html = ""
        try:
            from ..obs import profiler as _profiler

            # cached analysis only: the 2s-auto-refresh dashboard must
            # never trigger lowering/compiles
            prog_rows_src = _profiler.registry().summary(
                analyze=False
            )["programs"][:12]
        except Exception:
            prog_rows_src = []
        if prog_rows_src:
            def _fmt(v, scale=1.0, digits=1):
                return f"{v / scale:.{digits}f}" if v else "-"

            prog_rows = "".join(
                f"<tr><td>{r['program']}</td>"
                f"<td>{r['n_compiles']}</td>"
                f"<td>{_fmt(r['compile_s'], 1, 2)}</td>"
                f"<td>{r['dispatches']}</td>"
                f"<td>{_fmt(r['dispatch_ms_p50'], 1, 2)}</td>"
                f"<td>{_fmt(r['flops'], 1e9, 2)}</td>"
                f"<td>{_fmt(r['bytes_accessed'], 1e6, 1)}</td>"
                f"<td>{r.get('mfu') if r.get('mfu') is not None else '-'}"
                f"</td></tr>"
                for r in prog_rows_src
            )
            prog_html = (
                "<h3>device programs (cost observatory)</h3>"
                "<table><tr><th>program</th><th>compiles</th>"
                "<th>compile s</th><th>dispatches</th><th>ms p50</th>"
                "<th>GFLOP</th><th>MB touched</th><th>MFU</th></tr>"
                f"{prog_rows}</table>"
            )
        trace_html = ""
        try:
            from .. import obs as _obs

            spans = _obs.recorder().recent(16)  # newest first, O(16)
        except Exception:
            spans = []
        if spans:
            now = time.perf_counter()
            span_rows = "".join(
                f"<tr><td>{s.name}</td><td>{s.trace_id}</td>"
                f"<td>{s.duration_s * 1e3:.2f}</td>"
                f"<td>{(now - s.t0):.1f}s ago</td></tr>"
                for s in spans
            )
            trace_html = (
                "<h3>recent spans (flight recorder)</h3>"
                "<table><tr><th>span</th><th>trace</th><th>dur ms</th>"
                f"<th>started</th></tr>{span_rows}</table>"
            )
        return (
            "<html><head><title>pathway-tpu</title>"
            '<meta http-equiv="refresh" content="2">'
            "<style>body{font-family:monospace;background:#111;color:#ddd}"
            "table{border-collapse:collapse}td,th{border:1px solid #444;"
            "padding:4px 10px}</style></head><body>"
            f"<h2>pathway-tpu &middot; frontier={self.scheduler.frontier} "
            f"&middot; uptime={time.time() - self.started_at:.0f}s</h2>"
            "<table><tr><th>operator</th><th>id</th><th>rows in</th>"
            f"<th>rows out</th></tr>{rows}</table>"
            f"{serve_html}{kv_html}{fabric_html}{prog_html}{trace_html}"
            '<p><a href="/metrics">/metrics</a> &middot; '
            '<a href="/debug/trace">/debug/trace</a> &middot; '
            '<a href="/debug/profile">/debug/profile</a></p></body></html>'
        )

    def start(self) -> None:
        if self._server is not None:
            return
        render = self.render

        render_html = self.render_dashboard

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if self.path == "/metrics":
                    body = render().encode()
                    ctype = "text/plain; version=0.0.4"
                elif self.path in ("/", "/dashboard"):
                    body = render_html().encode()
                    ctype = "text/html"
                elif self.path.split("?", 1)[0] == "/debug/trace":
                    # flight-recorder dump: Perfetto-loadable Chrome trace
                    # JSON (?trace=<id> filters to one request's spans)
                    from urllib.parse import parse_qsl as _pq

                    from .. import obs as _obs

                    body = _obs.chrome_trace_dump(
                        dict(_pq(self.path.partition("?")[2]))
                    ).encode()
                    ctype = "application/json"
                elif self.path.split("?", 1)[0] == "/debug/profile":
                    # device cost observatory: per-program
                    # compile/FLOPs/bytes/dispatch-ms/roofline table
                    # (?memory=1 adds the memory watermarks)
                    from urllib.parse import parse_qsl as _pq

                    from ..obs import profiler as _profiler

                    body = _profiler.profile_dump(
                        dict(_pq(self.path.partition("?")[2]))
                    ).encode()
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        try:
            self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        except OSError as exc:
            raise OSError(
                exc.errno, f"the metrics server cannot bind port {self.port} "
                f"(taken by another run?): {exc.strerror}") from exc
        threading.Thread(target=self._server.serve_forever, daemon=True,
                         name="pw-metrics").start()

    def stop(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


class ProgressReporter:
    """Periodic console summaries (reference: src/engine/progress_reporter.rs)."""

    def __init__(self, scheduler, interval_s: float = 10.0):
        self.scheduler = scheduler
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.interval_s):
                total_in = sum(op.rows_in for op in self.scheduler.operators)
                total_out = sum(op.rows_out for op in self.scheduler.operators)
                print(
                    f"[pathway-tpu] frontier={self.scheduler.frontier} "
                    f"rows_in={total_in} rows_out={total_out} "
                    f"operators={len(self.scheduler.operators)}"
                )

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()


class WorkloadTracker:
    """Elastic-scaling signal (reference: src/engine/workload_tracker.rs:30 +
    cli.py exit codes 10/12): tracks the busy fraction of the streaming loop
    over a window and recommends down/up-scaling.

    Enabled with PATHWAY_ELASTIC=1; the `pathway-tpu spawn` supervisor
    restarts with 0.5x/2x processes on the corresponding exit codes.
    """

    # canonical protocol constants live in cli.py
    from ..cli import EXIT_CODE_DOWNSCALE, EXIT_CODE_UPSCALE  # noqa: F401

    def __init__(self, window_s: float = 30.0, low: float = 0.2, high: float = 0.9):
        self.window_s = window_s
        self.low = low
        self.high = high
        self.samples: list[tuple[float, float]] = []  # (ts, busy_fraction)
        self.started = time.time()

    def record(self, busy_fraction: float) -> None:
        now = time.time()
        self.samples.append((now, busy_fraction))
        cutoff = now - self.window_s
        while self.samples and self.samples[0][0] < cutoff:
            self.samples.pop(0)

    def recommendation(self) -> int | None:
        """None, or an exit code requesting rescale."""
        if time.time() - self.started < self.window_s or not self.samples:
            return None
        avg = sum(b for _t, b in self.samples) / len(self.samples)
        if avg < self.low:
            return self.EXIT_CODE_DOWNSCALE
        if avg > self.high:
            return self.EXIT_CODE_UPSCALE
        return None


class ErrorLog:
    """Collects Value::Error provenance (reference: ``Graph::error_log``;
    ``pw.global_error_log``)."""

    def __init__(self) -> None:
        self.entries: list[dict] = []
        self._lock = threading.Lock()
        self.limit = 10_000

    def record(self, message: str, operator: str = "", trace: str = "") -> None:
        if not trace:
            # default provenance: the user stack frame that created the
            # operator currently executing (set by the scheduler)
            from .graph import current_op_trace

            t = current_op_trace()
            trace = str(t) if t is not None else ""
        with self._lock:
            if len(self.entries) < self.limit:
                self.entries.append(
                    {"message": message, "operator": operator, "trace": trace,
                     "ts": time.time()}
                )

    def clear(self) -> None:
        with self._lock:
            self.entries.clear()


global_error_log = ErrorLog()


# ---------------------------------------------------------------------------
# Tracing spans (reference: src/engine/telemetry.rs:296-601 OTLP export +
# internals/graph_runner/telemetry.py run-scoped tracer)
# ---------------------------------------------------------------------------

class Span:
    __slots__ = ("name", "start", "end", "attributes", "parent")

    def __init__(self, name: str, parent: "Span | None" = None, **attributes):
        self.name = name
        self.parent = parent
        self.attributes = attributes
        self.start = time.time()
        self.end: float | None = None

    def finish(self) -> None:
        self.end = time.time()

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "duration_ms": round(((self.end or time.time()) - self.start) * 1e3, 3),
            "parent": self.parent.name if self.parent else None,
            "attributes": self.attributes,
        }


class Tracer:
    """Run-scoped tracer: spans collect in-process and export (1) to an
    OpenTelemetry SDK when one is importable, (2) as JSON lines to
    PATHWAY_TRACE_FILE, (3) always to `tracer.spans` for tests/tools."""

    def __init__(self):
        self.spans: list[Span] = []
        self.last_spans: list[Span] = []  # drained on export (inspection)
        self._stack: list[Span] = []
        self._otel = None
        try:  # optional bridge
            from opentelemetry import trace as _ot

            self._otel = _ot.get_tracer("pathway_tpu_torch")
        except Exception:
            self._otel = None

    def span(self, name: str, **attributes) -> "_SpanCtx":
        return _SpanCtx(self, name, attributes)

    def export(self) -> None:
        """Drain accumulated spans: write to PATHWAY_TRACE_FILE (if set),
        push OTLP/HTTP JSON to PATHWAY_MONITORING_SERVER (if set — the
        reference's telemetry.rs:296-601 OTLP exporter), and move them to
        `last_spans`, so repeated pw.run() calls in one process neither
        re-export nor grow memory without bound."""
        import json as _json
        import os as _os

        spans, self.spans = self.spans, []
        self.last_spans = spans
        path = _os.environ.get("PATHWAY_TRACE_FILE")
        if path:
            try:
                with open(path, "a", encoding="utf-8") as f:
                    for s in spans:
                        f.write(_json.dumps(s.as_dict()) + "\n")
            except Exception:
                pass
        endpoint = _os.environ.get("PATHWAY_MONITORING_SERVER")
        if endpoint and spans:
            try:
                otlp_export_spans(endpoint, spans)
            except Exception:
                import logging

                logging.getLogger(__name__).warning(
                    "OTLP span export to %s failed", endpoint, exc_info=True
                )


class _SpanCtx:
    def __init__(self, tracer: Tracer, name: str, attributes: dict):
        self.tracer = tracer
        self.name = name
        self.attributes = attributes
        self.span: Span | None = None
        self._otel_cm = None

    def __enter__(self) -> Span:
        parent = self.tracer._stack[-1] if self.tracer._stack else None
        self.span = Span(self.name, parent, **self.attributes)
        self.tracer._stack.append(self.span)
        self.tracer.spans.append(self.span)
        if self.tracer._otel is not None:
            try:
                self._otel_cm = self.tracer._otel.start_as_current_span(self.name)
                self._otel_cm.__enter__()
            except Exception:
                self._otel_cm = None
        return self.span

    def __exit__(self, *exc) -> None:
        assert self.span is not None
        self.span.finish()
        if self.tracer._stack and self.tracer._stack[-1] is self.span:
            self.tracer._stack.pop()
        if self._otel_cm is not None:
            try:
                self._otel_cm.__exit__(*exc)
            except Exception:
                pass


global_tracer = Tracer()


# ---------------------------------------------------------------------------
# OTLP/HTTP export (reference: src/engine/telemetry.rs:296,601 — OTel OTLP
# push of spans + metrics).  The OTLP JSON encoding needs no SDK: spans POST
# to {endpoint}/v1/traces, metrics to {endpoint}/v1/metrics.
# ---------------------------------------------------------------------------

_RESOURCE = {
    "attributes": [
        {"key": "service.name", "value": {"stringValue": "pathway-tpu"}},
    ]
}


def _post_json(url: str, payload: dict) -> None:
    import json as _json
    import urllib.request

    req = urllib.request.Request(
        url, data=_json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    urllib.request.urlopen(req, timeout=10).read()


def otlp_export_spans(endpoint: str, spans: list["Span"]) -> None:
    import os as _os

    trace_id = _os.urandom(16).hex()
    span_ids = {id(s): _os.urandom(8).hex() for s in spans}
    otlp = []
    for s in spans:
        otlp.append({
            "traceId": trace_id,
            "spanId": span_ids[id(s)],
            "parentSpanId": (
                span_ids.get(id(s.parent), "") if s.parent else ""
            ),
            "name": s.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(s.start * 1e9)),
            "endTimeUnixNano": str(int((s.end or time.time()) * 1e9)),
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in s.attributes.items()
            ],
        })
    _post_json(
        endpoint.rstrip("/") + "/v1/traces",
        {"resourceSpans": [{
            "resource": _RESOURCE,
            "scopeSpans": [{
                "scope": {"name": "pathway_tpu"},
                "spans": otlp,
            }],
        }]},
    )


def otlp_export_metrics(endpoint: str, scheduler, fabric=None) -> None:
    """Push per-operator row counters as OTLP sums (the /metrics content in
    push form).  With a fabric attached, the exchange counters — including
    the sender-queue depth/flush/coalesce stats — ride along as
    `pathway.fabric` points labeled by stat name."""
    now = str(int(time.time() * 1e9))
    points = []
    for op in scheduler.operators:
        for direction, val in (("in", op.rows_in), ("out", op.rows_out)):
            points.append({
                "asInt": str(val),
                "timeUnixNano": now,
                "attributes": [
                    {"key": "operator", "value": {"stringValue": op.name}},
                    {"key": "id", "value": {"stringValue": str(op.id)}},
                    {"key": "direction", "value": {"stringValue": direction}},
                ],
            })
    metrics = [{
        "name": "pathway.operator.rows",
        "sum": {
            "aggregationTemporality": 2,  # CUMULATIVE
            "isMonotonic": True,
            "dataPoints": points,
        },
    }]
    try:
        from ..serve.metrics import otlp_points

        serve_points = otlp_points(now)
    except Exception:
        serve_points = []
    if serve_points:
        metrics.append({
            "name": "pathway.serve.requests",
            "sum": {
                "aggregationTemporality": 2,  # CUMULATIVE
                "isMonotonic": True,
                "dataPoints": serve_points,
            },
        })
    # device-program points ride their OWN metric families —
    # mixing them into the monotonic pathway.serve.requests sum would
    # corrupt that series, and a metric's data points must share one
    # value type, so int counts and float seconds split into two.  All
    # four profiler counters (compiles/dispatches/compile_s/dispatch_s)
    # only ever grow: both sums are monotonic.
    try:
        from ..obs import profiler as _profiler

        xla_points = _profiler.otlp_points(now)
    except Exception:
        xla_points = []
    for fam_name, fam_points in (
        ("pathway.xla", [p for p in xla_points if "asInt" in p]),
        ("pathway.xla.seconds", [p for p in xla_points if "asDouble" in p]),
    ):
        if fam_points:
            metrics.append({
                "name": fam_name,
                "sum": {
                    "aggregationTemporality": 2,  # CUMULATIVE
                    "isMonotonic": True,
                    "dataPoints": fam_points,
                },
            })
    if fabric is not None:
        fabric_points = []
        for k, v in dict(fabric.stats).items():
            point = {
                "timeUnixNano": now,
                "attributes": [
                    {"key": "stat", "value": {"stringValue": k}},
                ],
            }
            if isinstance(v, float):
                point["asDouble"] = v
            else:
                point["asInt"] = str(v)
            fabric_points.append(point)
        metrics.append({
            "name": "pathway.fabric",
            "sum": {
                "aggregationTemporality": 2,  # CUMULATIVE
                "isMonotonic": False,  # queue depth is a gauge-like stat
                "dataPoints": fabric_points,
            },
        })
    _post_json(
        endpoint.rstrip("/") + "/v1/metrics",
        {"resourceMetrics": [{
            "resource": _RESOURCE,
            "scopeMetrics": [{
                "scope": {"name": "pathway_tpu"},
                "metrics": metrics,
            }],
        }]},
    )
