"""The port's OTLP/HTTP export (``tests/test_otlp.py``'s case): with
``PATHWAY_MONITORING_SERVER`` set, a run's spans and per-operator
metrics reach a local collector double as OTLP JSON, and the run's
output equals the JAX package's."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.internals import parse_graph as tpg


def _collector():
    received = []

    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            received.append((self.path, json.loads(self.rfile.read(n))))
            self.send_response(200)
            self.end_headers()
            self.wfile.write(b"{}")

    srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, received


def _run(pw, **kw):
    t = pw.debug.table_from_markdown("""
    | v
  1 | 1
  2 | 2
    """)
    out = t.groupby().reduce(s=pw.reducers.sum(t.v))
    seen = []
    pw.io.subscribe(out, on_change=lambda key, row, time, is_addition:
                    seen.append(row["s"]))
    pw.run(monitoring_level=pw.MonitoringLevel.NONE, **kw)
    return seen


def test_otlp_spans_and_metrics_push(monkeypatch):
    jpg.G.clear()
    want = _run(jpw)
    jpg.G.clear()
    srv, received = _collector()
    monkeypatch.setenv("PATHWAY_MONITORING_SERVER",
                       f"http://127.0.0.1:{srv.server_port}")
    tpg.G.clear()
    try:
        assert _run(tpw, device="cpu") == want == [3]
    finally:
        tpg.G.clear()
        srv.shutdown()

    paths = [p for p, _ in received]
    assert "/v1/traces" in paths and "/v1/metrics" in paths
    spans = [s for p, b in received if p == "/v1/traces"
             for rs in b["resourceSpans"] for ss in rs["scopeSpans"]
             for s in ss["spans"]]
    names = {s["name"] for s in spans}
    assert {"pathway.graph_build", "pathway.run"} <= names
    assert all(len(s["traceId"]) == 32 and len(s["spanId"]) == 16
               for s in spans)
    # top-level spans carry empty parent ids (valid OTLP)
    assert all("parentSpanId" in s for s in spans)

    metrics = next(b for p, b in received if p == "/v1/metrics")
    m = metrics["resourceMetrics"][0]["scopeMetrics"][0]["metrics"][0]
    assert m["name"] == "pathway.operator.rows"
    assert m["sum"]["dataPoints"]
    rows_out = {(a["value"]["stringValue"])
                for p in m["sum"]["dataPoints"] for a in p["attributes"]
                if a["key"] == "direction"}
    assert rows_out == {"in", "out"}
