"""The port's monitoring and telemetry: the terminal dashboard, the run's
spans, the operators' state sizes on ``/metrics``
(``tests/test_monitoring.py``'s cases but the viz plot, which waits for
``stdlib/viz``), and the port's own checks — a taken metrics port raises,
a failed OTLP export leaves a warning and the run's result, and
``profile`` reads ``/debug/profile``.  Every run's output is held to the
JAX package's on the same rows."""

import io
import json
import logging
import socket
import time

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.engine.runner import run_tables as jrun_tables
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.engine.runner import GraphRunner
from pathway_tpu_torch.internals import parse_graph as tpg

from .torch_parity import fresh_port, named  # noqa: F401


@pytest.fixture(autouse=True)
def _fresh(fresh_port):  # noqa: F811
    yield


def _free_port() -> int:
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def _counts(pw, rows):
    t = pw.debug.table_from_rows(pw.schema_from_types(w=str), rows)
    return t.groupby(t.w).reduce(t.w, c=pw.reducers.count())


def _runner_and_want(rows):
    """A port GraphRunner over the word count of ``rows`` and the JAX
    package's squashed capture of the same program."""
    jpg.G.clear()
    [jcap] = jrun_tables(_counts(jpw, rows))
    jpg.G.clear()
    tpg.G.clear()
    out = _counts(tpw, rows)._materialize_capture()
    return GraphRunner([out], device="cpu"), out, jcap.squash()


def _squash(caps, sink):
    return {k: named(tuple(r)) for k, r in caps[sink.id].squash().items()}


def test_dashboard_renders_operator_table():
    from pathway_tpu_torch.internals.monitoring import (
        MonitoringDashboard,
        MonitoringLevel,
    )

    runner, sink, want = _runner_and_want([("a",), ("b",), ("a",)])
    buf = io.StringIO()
    dash = MonitoringDashboard(runner.lg.scheduler, MonitoringLevel.ALL,
                               interval_s=0.05, file=buf)
    dash.start()
    caps = runner.run_batch()
    time.sleep(0.15)
    dash.stop()
    assert _squash(caps, sink) == want
    text = buf.getvalue()
    assert "pathway-tpu" in text
    assert "frontier" in text
    assert "groupby" in text  # per-operator row present at level ALL
    assert "rows in" in text


def test_dashboard_in_out_only_shows_endpoints():
    from pathway_tpu_torch.internals.monitoring import (
        MonitoringDashboard,
        MonitoringLevel,
    )

    runner, sink, want = _runner_and_want([("a",)])
    assert _squash(runner.run_batch(), sink) == want
    dash = MonitoringDashboard(runner.lg.scheduler, MonitoringLevel.IN_OUT,
                               interval_s=10, file=io.StringIO())
    frame = dash._render()
    assert "input" in frame
    assert "groupby" not in frame  # interior ops hidden at IN_OUT


def test_tracer_spans_and_file_export(tmp_path, monkeypatch):
    from pathway_tpu_torch.engine import telemetry

    trace_file = tmp_path / "trace.jsonl"
    monkeypatch.setenv("PATHWAY_TRACE_FILE", str(trace_file))
    monkeypatch.setattr(telemetry, "global_tracer", telemetry.Tracer())

    def run(pw, **kw):
        got = {}
        pw.io.subscribe(_counts(pw, [("a",), ("b",)]),
                        on_change=lambda key, row, time, is_addition:
                        got.update({row["w"]: row["c"]}))
        pw.run(monitoring_level=pw.MonitoringLevel.NONE, **kw)
        return got

    jpg.G.clear()
    want = run(jpw)
    jpg.G.clear()
    trace_file.unlink(missing_ok=True)
    assert run(tpw, device="cpu") == want == {"a": 1, "b": 1}
    # export() drains spans into last_spans (repeat runs never re-export)
    assert telemetry.global_tracer.spans == []
    spans = {s.name: s for s in telemetry.global_tracer.last_spans}
    assert "pathway.graph_build" in spans
    assert "pathway.run" in spans
    assert spans["pathway.run"].end is not None
    names = {json.loads(ln)["name"]
             for ln in trace_file.read_text().splitlines()}
    assert {"pathway.graph_build", "pathway.run"} <= names


def test_state_size_telemetry():
    """/metrics exposes per-operator arrangement sizes."""
    from pathway_tpu_torch.engine.telemetry import MetricsServer

    def build(pw):
        t = pw.debug.table_from_rows(pw.schema_from_types(g=str, v=int),
                                     [(f"g{i % 5}", i) for i in range(40)])
        return t.groupby(t.g).reduce(t.g, s=pw.reducers.sum(t.v))

    jpg.G.clear()
    [jcap] = jrun_tables(build(jpw))
    jpg.G.clear()
    sink = build(tpw)._materialize_capture()
    runner = GraphRunner([sink], device="cpu")
    assert _squash(runner.run_batch(), sink) == jcap.squash()
    gb = next(op for op in runner.lg.scheduler.operators
              if op.name == "groupby")
    assert gb.state_size() >= 5  # groups + last_out retained
    metrics = MetricsServer(runner.lg.scheduler).render()
    assert "pathway_operator_state_entries" in metrics
    assert 'operator="groupby"' in metrics


def test_dashboard_connector_and_logs_sections():
    """Per-connector minibatch/minute/total columns, the busy ms/s
    operator column, and a logs panel with error-log entries."""
    from pathway_tpu_torch.engine.telemetry import global_error_log
    from pathway_tpu_torch.internals.monitoring import (
        MonitoringDashboard,
        MonitoringLevel,
    )

    global_error_log.clear()
    runner, sink, want = _runner_and_want([("a",), ("b",)])
    buf = io.StringIO()
    dash = MonitoringDashboard(runner.lg.scheduler, MonitoringLevel.ALL,
                               interval_s=0.05, file=buf)
    dash.start()
    assert _squash(runner.run_batch(), sink) == want
    global_error_log.record("boom happened", operator="select")
    logging.getLogger("pathway_tpu_torch.test").warning("disk almost full")
    time.sleep(0.15)
    dash.stop()
    text = buf.getvalue()
    for part in ("connectors", "last minibatch", "last minute",
                 "since start", "busy ms/s", "logs", "boom happened",
                 "disk almost full"):
        assert part in text, part
    global_error_log.clear()


# -- the port's own ---------------------------------------------------------


def _subscribed(pw, **run_kw):
    got = []
    pw.io.subscribe(_counts(pw, [("a",), ("b",), ("a",)]),
                    on_change=lambda key, row, time, is_addition:
                    got.append((row["w"], row["c"], is_addition)))
    pw.run(**run_kw)
    return sorted(got)


def test_a_taken_metrics_port_raises(monkeypatch):
    """The JAX server returns quietly when its port is taken and the run
    goes on without metrics; the port's raises, naming the port."""
    from pathway_tpu_torch.engine import telemetry

    holder = socket.socket()
    holder.bind(("0.0.0.0", 0))
    holder.listen(1)
    port = holder.getsockname()[1]
    monkeypatch.setattr(telemetry, "METRICS_PORT", port)
    try:
        with pytest.raises(OSError, match=f"cannot bind port {port}"):
            _subscribed(tpw, device="cpu", with_http_server=True)
    finally:
        holder.close()
    tpg.G.clear()
    # a free port serves while the run runs, and the output is the JAX
    # package's
    jpg.G.clear()
    want = _subscribed(jpw)
    jpg.G.clear()
    monkeypatch.setattr(telemetry, "METRICS_PORT", _free_port())
    assert _subscribed(tpw, device="cpu", with_http_server=True) == want


def test_failed_otlp_export_warns_and_keeps_the_result(monkeypatch, caplog):
    """An OTLP endpoint that refuses the export leaves a warning, as in
    the JAX package, and the run's output stands."""
    jpg.G.clear()
    want = _subscribed(jpw)
    jpg.G.clear()
    monkeypatch.setenv("PATHWAY_MONITORING_SERVER",
                       f"http://127.0.0.1:{_free_port()}")
    with caplog.at_level(logging.WARNING):
        got = _subscribed(tpw, device="cpu")
    assert got == want
    messages = [r.getMessage() for r in caplog.records]
    assert any("OTLP metrics export to" in m and "failed" in m
               for m in messages), messages


def test_profile_command_reads_debug_profile():
    """``profile`` fetches ``/debug/profile`` from the REST webserver and
    from the metrics server, and prints the program table."""
    import numpy as np

    from pathway_tpu_torch.cli import profile_command
    from pathway_tpu_torch.engine.telemetry import MetricsServer
    from pathway_tpu_torch.io.http import PathwayWebserver
    from pathway_tpu_torch.obs import profiler

    prog = profiler.profiled("pw.test_profile_probe",
                             lambda x: np.asarray(x) * 2)
    for _ in range(3):
        prog(np.arange(8.0))
    web = PathwayWebserver("127.0.0.1", _free_port())
    web._ensure_started()
    sched = type("S", (), {"frontier": 0, "operators": ()})()
    metrics = MetricsServer(sched, port=_free_port())
    metrics.start()
    try:
        for port in (web.port, metrics.port):
            out = io.StringIO()
            assert profile_command(f"http://127.0.0.1:{port}", out=out) == 0
            table = out.getvalue()
            assert "pw.test_profile_probe" in table and "disp" in table
            out = io.StringIO()
            assert profile_command(f"http://127.0.0.1:{port}", as_json=True,
                                   out=out) == 0
            data = json.loads(out.getvalue())
            # the registered program (its dispatch windows are timed on
            # the card only)
            assert any(r["program"] == "pw.test_profile_probe"
                       for r in data["programs"])
            assert data["n_device_programs"] >= 1
    finally:
        metrics.stop()
        web.shutdown()
    assert profile_command("http://127.0.0.1:1", out=io.StringIO()) == 1


def test_plan_and_spawn_from_env_commands(monkeypatch, tmp_path):
    """``plan`` prints the JAX package's knobs, with the port's reasons;
    ``spawn-from-env`` without a program says so and exits 2, and with
    one runs it under the supervisor."""
    import sys

    from pathway_tpu.cli import plan_command as jplan_command
    from pathway_tpu_torch.cli import main, plan_command

    outs = []
    for cmd in (jplan_command, plan_command):
        buf = io.StringIO()
        assert cmd(as_json=True, out=buf) == 0
        outs.append(json.loads(buf.getvalue()))
    knobs = [[d["knob"] for d in o["decisions"]] for o in outs]
    assert knobs[1] == knobs[0] and "processes" in knobs[1]
    buf = io.StringIO()
    assert plan_command(out=buf) == 0 and "processes" in buf.getvalue()

    monkeypatch.delenv("PATHWAY_SPAWN_PROGRAM", raising=False)
    assert main(["spawn-from-env"]) == 2
    flag = tmp_path / "ran"
    script = tmp_path / "app.py"
    script.write_text(
        "import os, pathlib\n"
        f"pathlib.Path({str(flag)!r}).write_text("
        "os.environ['PATHWAY_PROCESS_ID'] + os.environ['PATHWAY_SPAWNED'])\n")
    monkeypatch.setenv("PATHWAY_SPAWN_PROGRAM", sys.executable)
    monkeypatch.setenv("PATHWAY_SPAWN_ARGS", str(script))
    monkeypatch.setenv("PATHWAY_PROCESSES", "1")
    assert main(["spawn-from-env"]) == 0
    assert flag.read_text() == "01"
