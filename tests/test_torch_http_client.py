"""The port's HTTP client connectors against the JAX package's.

``pw.io.http.read`` runs the cases of ``tests/test_http_openapi.py``
(a dribbled Content-Length body, raw messages through a
``response_mapper`` after 503s, a reconnect mid-stream that must not
re-deliver, the raw format's schema rule) and of
``tests/test_advice_r4_fixes.py`` / ``tests/test_advice_r5_fixes.py``
(the trailing-buffer rules: a partial tail is a disconnect by default,
``flush_trailing`` delivers it, an identical tail on three attempts is
delivered, a changing one never is): each package reads the same local
endpoint in its own engine, and the captures are equal.

``pw.io.http.write`` posts each update row with its ``time`` and
``diff`` (the same bodies as the JAX writer's), and a POST that fails,
to a closed port or answered with an error status, fails the run.
"""

import http.server
import json
import logging
import threading
import time

import pytest

import pathway_tpu as jpw
import pathway_tpu_torch as tpw
from pathway_tpu.internals import parse_graph as jpg
from pathway_tpu_torch.internals import parse_graph as tpg

PACKAGES = {"jax": (jpw, jpg), "torch": (tpw, tpg)}


@pytest.fixture(autouse=True)
def _graphs():
    jpg.G.clear()
    tpg.G.clear()
    yield
    jpg.G.clear()
    tpg.G.clear()


def _run(pkg, idle_stop_s=1.5):
    pw, _pg = PACKAGES[pkg]
    if pkg == "jax":
        pw.run(idle_stop_s=idle_stop_s,
               monitoring_level=pw.MonitoringLevel.NONE)
    else:
        pw.run(idle_stop_s=idle_stop_s, device="cpu")


def _serve(handler_cls):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler_cls)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def _collect(pkg, url, field, schema=None, **read_kw):
    pw, pg = PACKAGES[pkg]
    pg.G.clear()
    kw = dict(read_kw)
    if schema is not None:
        kw["schema"] = schema(pw)
    if isinstance(kw.get("retry_policy"), dict):
        kw["retry_policy"] = pw.io.http.RetryPolicy(**kw["retry_policy"])
    t = pw.io.http.read(url, **kw)
    got = []
    pw.io.subscribe(t, on_change=lambda key, row, time, is_addition:
                    got.append((row[field], is_addition)))
    _run(pkg)
    pg.G.clear()
    return got


def _both(make_server, *args, **kw):
    """Each package reads a fresh server of ``make_server``; both
    captures, JAX's first."""
    out = []
    for pkg in ("jax", "torch"):
        srv, port, state = make_server()
        try:
            out.append((_collect(pkg, f"http://127.0.0.1:{port}/", *args,
                                 **kw), state))
        finally:
            srv.shutdown()
    return out


def _ab_schema(pw):
    class S(pw.Schema):
        a: int
        b: str

    return S


def _v_schema(pw):
    class S(pw.Schema):
        v: int

    return S


class _Quiet(http.server.BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass


def test_read_streaming_source_matches_jax():
    rows = [{"a": 1, "b": "x"}, {"a": 2, "b": "y"}, {"a": 3, "b": "z"}]

    def make():
        class H(_Quiet):
            def do_GET(self):
                body = b"".join(json.dumps(r).encode() + b"\n" for r in rows)
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                for i in range(0, len(body), 7):  # dribbled
                    self.wfile.write(body[i:i + 7])
                    self.wfile.flush()
                    time.sleep(0.01)

        srv, port = _serve(H)
        return srv, port, None

    (want, _), (got, _) = _both(make, "a", schema=_ab_schema,
                                autocommit_duration_ms=20)
    assert sorted(got) == sorted(want) == [(1, True), (2, True), (3, True)]


def test_read_raw_with_mapper_and_retry_matches_jax():
    def make():
        fails = {"n": 0}

        class H(_Quiet):
            def do_GET(self):
                if fails["n"] < 2:
                    fails["n"] += 1
                    self.send_response(503)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                body = b"alpha|beta"
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        srv, port = _serve(H)
        return srv, port, fails

    (want, jf), (got, tf) = _both(
        make, "data", format="raw", delimiter=b"|", n_retries=3,
        retry_policy={"first_delay_ms": 20},
        response_mapper=lambda b: b.upper(), autocommit_duration_ms=20)
    assert sorted(got) == sorted(want) == [(b"ALPHA", True), (b"BETA", True)]
    assert jf["n"] == tf["n"] == 2


def test_read_reconnect_mid_stream_matches_jax():
    msgs = [b"m1", b"m2", b"m3", b"m4"]

    def make():
        state = {"attempt": 0}

        class H(_Quiet):
            def do_GET(self):
                state["attempt"] += 1
                body = b"".join(m + b"\n" for m in msgs)
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if state["attempt"] == 1:
                    # the first two messages, then the connection drops
                    self.wfile.write(msgs[0] + b"\n" + msgs[1] + b"\n")
                    self.wfile.flush()
                    self.connection.close()
                    return
                self.wfile.write(body)

        srv, port = _serve(H)
        return srv, port, state

    (want, js), (got, ts) = _both(
        make, "data", format="raw", n_retries=3,
        retry_policy={"first_delay_ms": 20}, autocommit_duration_ms=20)
    assert sorted(got) == sorted(want) == [(m, True) for m in msgs]
    assert js["attempt"] >= 2 and ts["attempt"] >= 2


def test_read_raw_rejects_a_custom_schema():
    for pw, _pg in PACKAGES.values():
        with pytest.raises(ValueError, match="raw"):
            pw.io.http.read("http://x/", schema=_v_schema(pw), format="raw")


def _unterminated(payload_fn):
    """A server with no Content-Length that closes after ``payload_fn(n)``
    on its n-th request."""

    def make():
        counter = {"n": 0}

        class H(_Quiet):
            def do_GET(self):
                counter["n"] += 1
                self.send_response(200)
                self.send_header("Connection", "close")
                self.end_headers()
                self.wfile.write(payload_fn(counter["n"]))

        srv = http.server.HTTPServer(("127.0.0.1", 0), H)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        return srv, srv.server_address[1], counter

    return make


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_read_partial_tail_is_a_disconnect_by_default():
    make = _unterminated(lambda n: b'{"v": 1}\n{"v": 2}\n{"v": 3')
    (want, _), (got, _) = _both(make, "v", schema=_v_schema, n_retries=0)
    assert sorted(got) == sorted(want) == [(1, True), (2, True)]


def test_read_flush_trailing_delivers_the_tail():
    make = _unterminated(lambda n: b'{"v": 1}\n{"v": 2}')
    (want, _), (got, _) = _both(make, "v", schema=_v_schema,
                                flush_trailing=True)
    assert sorted(got) == sorted(want) == [(1, True), (2, True)]


def test_read_stable_tail_delivered_after_three_identical_reads(caplog):
    make = _unterminated(lambda n: b'{"v": 1}\n{"v": 2}\n{"v": 3}')
    with caplog.at_level(logging.INFO):
        (want, _), (got, _) = _both(
            make, "v", schema=_v_schema, n_retries=5,
            retry_policy={"first_delay_ms": 10, "backoff_factor": 1.0})
    assert sorted(got) == sorted(want) == [(1, True), (2, True), (3, True)]
    port_msgs = [r.getMessage() for r in caplog.records
                 if r.name == "pathway_tpu_torch.io.http"]
    assert any("connection ended mid-message" in m for m in port_msgs)
    assert any("delivering it as the final record" in m for m in port_msgs)


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_read_changing_tail_retries_to_failure():
    make = _unterminated(lambda n: b'{"v": 1}\n{"v": 2' + b"0" * n)
    (want, js), (got, ts) = _both(
        make, "v", schema=_v_schema, n_retries=3,
        retry_policy={"first_delay_ms": 10, "backoff_factor": 1.0})
    assert sorted(got) == sorted(want) == [(1, True)]
    assert js["n"] == ts["n"] == 4  # the first read and three retries


def test_retry_policy_matches_jax():
    for kw in ({}, {"first_delay_ms": 20, "backoff_factor": 3.0}):
        for attempt in range(4):
            assert (tpw.io.http.RetryPolicy(**kw).delay_s(attempt)
                    == jpw.io.http.RetryPolicy(**kw).delay_s(attempt))
    assert tpw.io.http.RetryPolicy.default().first_delay_ms == 1000


# -- write ---------------------------------------------------------------------

class _Sink:
    """A local endpoint that records each POSTed JSON body, answering
    with ``status``."""

    def __init__(self, status=200):
        sink = self
        self.bodies = []

        class H(_Quiet):
            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                sink.bodies.append(json.loads(self.rfile.read(n)))
                self.send_response(status)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.srv, self.port = _serve(H)

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _write_stream(pw, url):
    t = pw.debug.table_from_markdown("""
    name | n | __time__ | __diff__
    a    | 1 | 2        | 1
    b    | 2 | 2        | 1
    a    | 1 | 4        | -1
    c    | 3 | 4        | 1
    """)
    pw.io.http.write(t, url)


def test_write_posts_each_update_like_jax():
    bodies = {}
    for pkg in ("jax", "torch"):
        pw, pg = PACKAGES[pkg]
        sink = _Sink()
        try:
            pg.G.clear()
            _write_stream(pw, f"http://127.0.0.1:{sink.port}/rows")
            _run(pkg)
        finally:
            sink.close()
        bodies[pkg] = sorted(sink.bodies, key=json.dumps)
    assert bodies["torch"] == bodies["jax"]
    assert sorted((b["name"], b["diff"]) for b in bodies["torch"]) == [
        ("a", -1), ("a", 1), ("b", 1), ("c", 3 - 2)]
    assert all(set(b) == {"name", "n", "time", "diff"}
               for b in bodies["torch"])


def test_a_failing_post_fails_the_run():
    import socket
    import urllib.error

    from pathway_tpu_torch.internals.trace import EngineErrorWithTrace

    with socket.socket() as s:  # a port that nothing listens on
        s.bind(("127.0.0.1", 0))
        closed = s.getsockname()[1]
    _write_stream(tpw, f"http://127.0.0.1:{closed}/rows")
    with pytest.raises(EngineErrorWithTrace, match="raw_output") as info:
        tpw.run(device="cpu")
    assert isinstance(info.value.__cause__, urllib.error.URLError)
    tpg.G.clear()
    sink = _Sink(status=500)
    try:
        _write_stream(tpw, f"http://127.0.0.1:{sink.port}/rows")
        with pytest.raises(EngineErrorWithTrace, match="500") as info:
            tpw.run(device="cpu")
        assert isinstance(info.value.__cause__, urllib.error.HTTPError)
    finally:
        sink.close()
    assert len(sink.bodies) == 1  # the first row's POST, then the failure
