"""The readers of the program's spans, on made-up device intervals and
spans: the three idle parts add up to ``device_idle.tokens`` and give each
idle instant to one part, ``row_occupancy.tokens`` weights rounds by their
time, ``admission_wait_ms.tokens`` joins ``serve.queue`` and
``engine.pending`` by trace id, and a window the ring has evicted spans
from, or a program without the spans, gives no reading."""

import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import spans as hspans
from benchmark.harness.stats import Run
from benchmark.harness.trace import DeviceTrace
from pathway_tpu_torch import obs
from pathway_tpu_torch.obs import tracer

IDLE = ("idle_issue.tokens", "idle_host.tokens", "idle_turnover.tokens")
ALL = IDLE + ("row_occupancy.tokens", "admission_wait_ms.tokens")


def _span(name, t0, t1, trace="run", **attrs):
    s = tracer.Span.__new__(tracer.Span)
    s.name, s.trace_id, s.parent_id = name, trace, 0
    s.span_id = next(tracer._span_ids)
    s.t0, s.t1, s.tid, s.attrs = t0, t1, 0, attrs or None
    return s


def _round(kind, t0, t_issued, t_sync, rows=4, capacity=4):
    return [_span(f"engine.issue.{kind}", t0, t_issued, rows=rows,
                  capacity=capacity),
            _span(f"engine.device.{kind}", t0, t_sync)]


@pytest.fixture
def recorder(monkeypatch):
    """A ring of the test's own spans in place of the process's."""
    def use(spans, capacity=1024):
        rec = tracer.FlightRecorder(capacity)
        for s in spans:
            rec.record(s)
        monkeypatch.setattr(obs, "recorder", lambda: rec)
        return rec
    return use


def _run(kernels, t_open=0.0, t_close=10.0):
    trace = DeviceTrace(torch.device("cpu"))
    trace._t_open, trace._t_close = t_open, t_close
    trace.window_s = t_close - t_open
    trace.cut = [("k", a, b) for a, b in kernels]
    return Run({}, {}, {"t_open": t_open, "t_close": t_close}, trace,
               t_close - t_open, 0.0)


def _read(run, names=ALL):
    return {n: bench_run.reader(n)(run) for n in names + ("device_idle.tokens",)}


# a mixed round (issue 1-2.5 s, sync 4 s), a host gap with one copy of
# the next round's arrays, a chain round (issue 5-6 s, sync 8 s), all in
# one serve batch from 0.5 s to 8.5 s
SPANS = (_round("mixed", 1.0, 2.5, 4.0) + [_span("engine.host_gap", 4.0, 5.0)]
         + _round("chain", 5.0, 6.0, 8.0)
         + [_span("serve.batch", 0.5, 8.5, trace="sched")])
KERNELS = [(1.2, 1.5), (1.8, 2.4), (2.6, 3.5), (4.5, 4.51), (5.1, 7.9)]


def test_the_idle_parts_add_up_to_device_idle(recorder):
    recorder(SPANS)
    got = _read(_run(KERNELS))
    # idle while issuing: 0.2 + 0.3 + 0.1 (mixed) + 0.1 (chain)
    assert got["idle_issue.tokens"] == pytest.approx(7.0)
    # after issue 0.1 + 0.5 (mixed) + 0.1 (chain); the gap 1.0 - 0.01
    assert got["idle_host.tokens"] == pytest.approx(16.9)
    # before the first dispatch 1.0, after the last sync 2.0
    assert got["idle_turnover.tokens"] == pytest.approx(30.0)
    assert sum(got[n] for n in IDLE) == pytest.approx(
        got["device_idle.tokens"], abs=1e-9)


def test_an_idle_instant_under_several_spans_lands_in_one_part(recorder):
    # the issue span, a host gap, a post-issue window and a serve batch
    # all cover 1-2 s: issue takes it; 2-3 s lies in a host gap and a
    # post-issue window at once and is counted once
    recorder(_round("step", 1.0, 2.0, 3.0)
             + [_span("engine.host_gap", 1.0, 3.0),
                _span("serve.batch", 0.0, 10.0, trace="sched")])
    got = _read(_run([(3.0, 10.0)]))
    assert got["idle_issue.tokens"] == pytest.approx(10.0)
    assert got["idle_host.tokens"] == pytest.approx(10.0)
    assert got["idle_turnover.tokens"] == pytest.approx(10.0)
    assert sum(got[n] for n in IDLE) == pytest.approx(
        got["device_idle.tokens"], abs=1e-9)


def test_row_occupancy_is_weighted_by_round_time(recorder):
    recorder(_round("mixed", 1.0, 1.1, 2.0, rows=2)
             + _round("chain", 3.0, 3.1, 6.0, rows=4)
             # dispatched after the window closed: not counted
             + _round("chain", 10.5, 10.6, 11.0, rows=1))
    got = _read(_run([]), ("row_occupancy.tokens",))
    # (2 x 1 + 4 x 3) / (4 x 1 + 4 x 3); unweighted it would read 75
    assert got["row_occupancy.tokens"] == pytest.approx(87.5)


def test_the_admission_wait_joins_queue_and_pending_by_trace(recorder):
    recorder([
        _span("serve.queue", 0.5, 1.0, trace="a"),
        _span("engine.pending", 1.1, 2.0, trace="a"),
        _span("serve.queue", 1.0, 3.0, trace="b"),
        _span("engine.pending", 3.0, 4.0, trace="b"),
        # admitted after the window closed: not counted
        _span("serve.queue", 8.0, 9.0, trace="c"),
        _span("engine.pending", 9.0, 11.0, trace="c"),
        # a request that never queued at the scheduler: not counted
        _span("engine.pending", 1.0, 9.0, trace="d"),
    ])
    got = _read(_run([]), ("admission_wait_ms.tokens",))
    assert got["admission_wait_ms.tokens"] == pytest.approx(2250.0)


def test_an_evicted_window_gives_no_reading(recorder, capsys):
    rounds = [s for k in range(6)
              for s in _round("chain", 1.0 + k, 1.2 + k, 1.9 + k)]
    # a ring of 8 keeps the last four rounds: the first two, inside the
    # window, were evicted
    rec = recorder(rounds, capacity=8)
    assert rec.n_recorded > len(rec)
    got = _read(_run([(1.5, 1.9)]))
    assert all(got[n] is None for n in ALL)
    assert "evicted" in capsys.readouterr().err
    # the same ring read against a window that opens after the oldest
    # kept span finished is whole
    got = _read(_run([(4.5, 4.9)], t_open=4.0))
    assert got["row_occupancy.tokens"] == pytest.approx(100.0)
    assert sum(got[n] for n in IDLE) == pytest.approx(
        got["device_idle.tokens"], abs=1e-9)


def test_a_program_without_the_spans_gives_no_reading(recorder):
    # an older program: dispatch->sync windows and host gaps, no issue
    # or pending spans
    recorder([_span("engine.device.chain", 1.0, 2.0),
              _span("engine.host_gap", 2.0, 3.0),
              _span("serve.queue", 0.5, 1.0, trace="a")])
    got = _read(_run([(1.0, 2.0)]))
    assert all(got[n] is None for n in ALL)
    assert got["device_idle.tokens"] == pytest.approx(90.0)


@pytest.mark.parametrize("xs,ys", [
    ([(0, 2), (3, 5)], [(1, 4)]),
    ([(0, 10)], [(1, 2), (3, 4), (9, 12)]),
    ([(0, 1)], []),
])
def test_interval_arithmetic_partitions(xs, ys):
    a, b = hspans.intersect(xs, ys), hspans.subtract(xs, ys)
    assert hspans.length(a) + hspans.length(b) == pytest.approx(
        hspans.length(xs))
    assert hspans.intersect(a, b) == []
