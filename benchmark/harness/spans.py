"""What the readers of the program's own spans share.

The spans come from the port's flight recorder
(``pathway_tpu_torch.obs.recorder()``), on ``perf_counter``: the clock to
which the device trace maps its kernel records through its marker
kernel, so spans and device intervals are compared directly.

- :func:`program_spans`: the recorder's spans, or None where the ring
  has evicted spans from inside the window (a partial window is never
  read as a whole one);
- :func:`idle_split`: the device's idle time in the window, each idle
  instant given to one part: ``issue`` (an ``engine.issue.*`` span is
  open: the host is still enqueuing a round), then ``host`` (inside an
  ``engine.host_gap``, or inside a round's dispatch->sync window after
  its issue ended), then ``turnover`` (the rest: batch formation,
  admission before a run's first dispatch, a run's end, between serve
  batches).  The three add up to the idle share of
  ``device_idle.tokens``;
- :func:`rounds`: each round dispatched in the window, its issue span
  paired with its dispatch->sync window by their common start;
- :func:`admission_waits`: each request's wait from ``serve.queue``'s
  start to ``engine.pending``'s end, joined by trace id.

Each prints what it found to standard error once a run.  A program
that records none of these spans (an older one) gives None, and the
readers leave their metric out.
"""

from __future__ import annotations

import sys

from .stats import percentile


def _say(msg: str) -> None:
    print(f"[spans] {msg}", file=sys.stderr)


def _memo(run, key: str, fn):
    """``fn(run)`` once a run: the readers of one run share it."""
    cache = run.__dict__.setdefault("_spans_memo", {})
    if key not in cache:
        cache[key] = fn(run)
    return cache[key]


# -- intervals: sorted lists of disjoint (start, end) ------------------------

def union(intervals) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def intersect(xs, ys) -> list[tuple[float, float]]:
    out = []
    i = j = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(xs, ys) -> list[tuple[float, float]]:
    out = []
    j = 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while a < b and k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append((a, ys[k][0]))
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append((a, b))
    return out


def length(xs) -> float:
    return sum(b - a for a, b in xs)


# -- the recorder -------------------------------------------------------------

def program_spans(run):
    return _memo(run, "spans", _program_spans)


def _program_spans(run):
    from pathway_tpu_torch import obs

    rec = obs.recorder()
    spans = [s for s in rec.snapshot() if s.t1 is not None]
    t0, t1 = run.result["t_open"], run.result["t_close"]
    overlap = sum(1 for s in spans if s.t1 >= t0 and s.t0 < t1)
    since = sum(1 for s in spans if s.t1 >= t0)
    _say(f"{overlap} spans overlap the window, {since} recorded from its "
         f"open to this read; the ring holds {rec.capacity}")
    # the ring keeps spans in the order they finished: where it has
    # evicted any, the oldest it kept must have finished before the
    # window opened, or the evicted ones may have lain inside it
    if rec.n_recorded > len(spans) and spans and spans[0].t1 >= t0:
        _say(f"the ring evicted {rec.n_recorded - len(spans)} spans, some "
             "from inside the window: the span readers read nothing")
        return None
    return spans


def _named(spans, prefix: str) -> list:
    return [s for s in spans if s.name.startswith(prefix)]


def _kind(span) -> str:
    return span.name.rsplit(".", 1)[1]


def _issued(spans) -> list:
    """(issue span, its dispatch->sync span) of every round recorded:
    the two start at the same dispatch, on the engine run's trace."""
    device = {(s.trace_id, s.t0): s for s in _named(spans, "engine.device.")}
    out = []
    for s in _named(spans, "engine.issue."):
        d = device.get((s.trace_id, s.t0))
        if d is not None:
            out.append((s, d))
    return out


def rounds(run):
    """(kind, rows, capacity, dispatch->sync seconds) of each round
    dispatched in the window, or None."""
    return _memo(run, "rounds", _rounds)


def _rounds(run):
    spans = program_spans(run)
    if spans is None:
        return None
    pairs = _issued(spans)
    if not pairs:
        _say("no engine.issue spans: the program does not record them")
        return None
    t0, t1 = run.result["t_open"], run.result["t_close"]
    out = [(_kind(s), s.attrs["rows"], s.attrs["capacity"], d.t1 - d.t0)
           for s, d in pairs if t0 <= s.t0 < t1]
    for kind in sorted({k for k, *_ in out}):
        rs = [(r, w) for k, r, _c, w in out if k == kind]
        _say(f"rows of the {len(rs)} {kind} rounds dispatched in the window:"
             f" mean {sum(r for r, _w in rs) / len(rs):.1f}, min "
             f"{min(r for r, _w in rs)}, {sum(w for _r, w in rs):.3f} s "
             "dispatch->sync")
    return out


# -- the device's idle time ---------------------------------------------------

def idle_split(run):
    """Seconds of the window: ``window``, ``idle``, and its parts
    ``issue``, ``host``, ``turnover``; None without a device trace or
    without the program's round spans."""
    return _memo(run, "idle", _idle_split)


def _idle_split(run):
    trace = run.trace
    if trace is None or trace.window_s <= 0:
        return None
    spans = program_spans(run)
    if spans is None:
        return None
    pairs = _issued(spans)
    if not pairs:
        _say("no engine.issue spans: the idle time is not split")
        return None
    w0, w1 = trace._t_open, trace._t_close

    def clip(ivs):
        return union((max(a, w0), min(b, w1)) for a, b in ivs)

    busy = union((a, b) for _n, a, b in trace.cut)
    idle = subtract([(w0, w1)], busy)
    issuing = clip((s.t0, s.t1) for s, _d in pairs)
    waiting = clip((s.t1, d.t1) for s, d in pairs)
    gaps = clip((s.t0, s.t1) for s in _named(spans, "engine.host_gap"))
    hosting = union(gaps + waiting)
    in_issue = intersect(idle, issuing)
    rest = subtract(idle, issuing)
    in_host = intersect(rest, hosting)
    rest = subtract(rest, hosting)
    out = {"window": w1 - w0, "idle": length(idle),
           "issue": length(in_issue), "host": length(in_host)}
    out["turnover"] = out["idle"] - out["issue"] - out["host"]

    def pct(x):
        return f"{100.0 * x / out['window']:.3f}%"

    _say(f"idle {out['idle']:.3f} s of {out['window']:.3f} s "
         f"({pct(out['idle'])}): issue {out['issue']:.3f} s "
         f"({pct(out['issue'])}), host {out['host']:.3f} s "
         f"({pct(out['host'])}), turnover {out['turnover']:.3f} s "
         f"({pct(out['turnover'])})")
    by: dict = {}
    for s, d in pairs:
        by.setdefault(_kind(s), []).append((s, d))
    for kind, ps in sorted(by.items()):
        iss = clip((s.t0, s.t1) for s, _d in ps)
        post = clip((s.t1, d.t1) for s, d in ps)
        _say(f"  {kind}: {sum(s.t0 < w1 and d.t1 > w0 for s, d in ps)} "
             f"rounds in the window; issuing {length(iss):.3f} s, idle "
             f"{length(intersect(idle, iss)):.3f} s of it; after issue "
             f"{length(post):.3f} s, idle {length(intersect(idle, post)):.3f}"
             " s of it")
    _say(f"  engine.host_gap: {length(gaps):.3f} s, idle "
         f"{length(intersect(idle, gaps)):.3f} s of it")
    for a, b in sorted(idle, key=lambda iv: iv[0] - iv[1])[:5]:
        g = [(a, b)]
        i_s = length(intersect(g, issuing))
        h_s = length(intersect(subtract(g, issuing), hosting))
        _say(f"  idle gap of {1e3 * (b - a):.3f} ms at {a - w0:.3f} s: "
             f"issue {1e3 * i_s:.3f}, host {1e3 * h_s:.3f}, turnover "
             f"{1e3 * (b - a - i_s - h_s):.3f} ms")
    batch = clip((s.t0, s.t1) for s in _named(spans, "serve.batch"))
    _say(f"  turnover: {length(intersect(rest, batch)):.3f} s inside "
         f"serve.batch, {length(subtract(rest, batch)):.3f} s outside")
    # after a sync nothing is left queued, so the device should be idle
    # in the host gaps, but for the copies of the next round's arrays
    # and the error of the clocks' alignment
    busy_in_gaps = length(intersect(busy, gaps))
    share = 100.0 * busy_in_gaps / length(gaps) if gaps else 0.0
    _say(f"alignment: the device is busy {busy_in_gaps:.4f} s of the "
         f"{length(gaps):.3f} s of host gaps ({share:.3f}%)")
    return out


# -- the admission wait -------------------------------------------------------

def admission_waits(run):
    """(total, queue part, pending part) in seconds of each request whose
    admission ended in the window, or None."""
    return _memo(run, "waits", _admission_waits)


def _admission_waits(run):
    spans = program_spans(run)
    if spans is None:
        return None
    pending = _named(spans, "engine.pending")
    if not pending:
        _say("no engine.pending spans: the program does not record them")
        return None
    queue = {s.trace_id: s for s in _named(spans, "serve.queue")}
    t0, t1 = run.result["t_open"], run.result["t_close"]
    out = []
    for p in pending:
        q = queue.get(p.trace_id)
        if q is not None and t0 <= p.t1 < t1:
            out.append((p.t1 - q.t0, q.t1 - q.t0, p.t1 - p.t0))
    if out:
        parts = list(zip(*out))
        _say(f"admission wait of {len(out)} requests (ms, p50 / p95): "
             + ", ".join(f"{name} {percentile(v, 50) * 1e3:.1f} / "
                         f"{percentile(v, 95) * 1e3:.1f}"
                         for name, v in zip(("total", "serve.queue",
                                             "engine.pending"), parts)))
    return out
