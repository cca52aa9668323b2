"""Request-scoped tracing and an always-on flight recorder (the port of
``pathway_tpu/obs/tracer.py``; it imports no JAX, and the port keeps its
own copy, OTLP helpers included).

- **Spans** are (name, trace_id, span_id, parent_id, t0, t1, attrs)
  records on the shared ``perf_counter`` timeline.  A *trace* groups
  every span of one request (or one engine run); parent links form the
  span tree.
- **Context** rides a ``contextvars.ContextVar`` so nested ``span()``
  blocks parent automatically within a thread, and crosses threads
  explicitly: capture ``current_context()`` (or a Span's ``.ctx``) on
  the submitting side, adopt it with ``use_context()`` / pass it as
  ``ctx=`` on the executing side.
- **The flight recorder** is a bounded ring (``deque(maxlen=...)``) of
  FINISHED spans, always on.  Recording one span costs two
  ``perf_counter`` calls, one small object and one GIL-atomic deque
  append.
- **Dumps** are Chrome-trace-event JSON (load in Perfetto /
  chrome://tracing): SIGUSR1 (installed on the first main-thread
  ``recorder()`` touch), and automatically on an engine failure.  The
  per-program dispatch counter tracks of ``obs/profiler.py`` ride in
  every dump.  When an OTLP endpoint is configured
  (``PATHWAY_MONITORING_SERVER``) a background flusher pushes finished
  spans as OTLP traces; with the ``opentelemetry`` SDK configured its
  tracer is used instead of the raw JSON encoding.

Hot-path idiom: measure with ``perf_counter`` yourself and call
:func:`record_span` retroactively — one recorder touch per interval,
no context-manager overhead inside the loop.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from contextvars import ContextVar

_log = logging.getLogger(__name__)

_PID = os.getpid()
# one shared timeline: chrome `ts` microseconds are offsets from this
# anchor, and the wall-clock pairing lets external tools align the dump
_EPOCH_PERF = time.perf_counter()
_EPOCH_WALL = time.time()

_span_ids = itertools.count(1)  # C-level counter: thread-safe, ~free
_trace_ids = itertools.count(1)

# (trace_id, span_id) of the innermost open span, or None
_current: ContextVar = ContextVar("pathway_trace", default=None)

DEFAULT_CAPACITY = 65536
_MAX_FAILURE_DUMPS = 4


def new_trace_id() -> str:
    """Mint a process-unique trace id (hex, 16 chars)."""
    return f"{_PID & 0xFFFF:04x}{next(_trace_ids) & 0xFFFFFFFFFFFF:012x}"


def context_from_trace_header(raw) -> tuple | None:
    """(trace_id, 0) from an ``X-Pathway-Trace`` header value, or None
    when absent/invalid (the caller then mints a fresh trace)."""
    tid = sanitize_trace_id(raw)
    return (tid, 0) if tid else None


def sanitize_trace_id(raw) -> str | None:
    """Validate an externally supplied trace id (the ``X-Pathway-Trace``
    header): 1-64 chars of [A-Za-z0-9_-], else None.  Accepting arbitrary
    bytes would let a caller inject header text through the echoed
    response header and garbage through the dump files."""
    import re

    if not isinstance(raw, str):
        return None
    # ASCII-only by construction: str.isalnum would admit Unicode
    # letters, defeating the injection rationale above
    if re.fullmatch(r"[A-Za-z0-9_-]{1,64}", raw):
        return raw
    return None


def chrome_trace_dump(params: dict | None = None) -> str:
    """A ``/debug/trace`` endpoint body: Chrome trace JSON of the flight
    recorder, filtered to ``params["trace"]`` when given."""
    tid = sanitize_trace_id((params or {}).get("trace"))
    return _RECORDER.chrome_trace_json(tid)


class Span:
    """One timed interval.  ``finish()`` stamps ``t1`` and lands the span
    in the flight recorder; a span is never recorded twice."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "t0", "t1",
                 "tid", "attrs")

    def __init__(self, name: str, trace_id: str, parent_id: int,
                 attrs: dict | None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = next(_span_ids)
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        self.t1: float | None = None
        self.tid = threading.get_ident()
        self.attrs = attrs

    @property
    def ctx(self) -> tuple:
        """Context tuple for parenting children (possibly cross-thread)."""
        return (self.trace_id, self.span_id)

    @property
    def duration_s(self) -> float:
        return ((self.t1 if self.t1 is not None else time.perf_counter())
                - self.t0)

    def set(self, **attrs) -> None:
        if self.attrs is None:
            self.attrs = attrs
        else:
            self.attrs.update(attrs)

    def finish(self, **attrs) -> None:
        if self.t1 is not None:
            return
        self.t1 = time.perf_counter()
        if attrs:
            self.set(**attrs)
        _RECORDER.record(self)

    def as_dict(self) -> dict:
        return {
            "name": self.name, "trace": self.trace_id,
            "span": self.span_id, "parent": self.parent_id,
            "t0": self.t0, "t1": self.t1, "tid": self.tid,
            "duration_ms": round(self.duration_s * 1e3, 3),
            "attrs": self.attrs or {},
        }


class FlightRecorder:
    """Bounded, always-on ring of finished spans.

    ``deque(maxlen=N)`` gives O(1) append with automatic oldest-first
    eviction and GIL-atomic thread safety — no lock on the record path.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self.enabled = True
        self.n_recorded = 0  # lifetime count (ring evicts past capacity)
        self.last_dump_path: str | None = None
        self.failure_dumps = 0

    # -- recording ---------------------------------------------------------
    def record(self, span: Span) -> None:
        if self.enabled:
            self._ring.append(span)
            self.n_recorded += 1

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self) -> list:
        """Consistent copy of the ring, oldest first."""
        return list(self._ring)

    def recent(self, n: int) -> list:
        """The newest ``n`` spans, newest first — O(n), no full-ring
        copy (the dashboard's auto-refresh path)."""
        import itertools

        return list(itertools.islice(reversed(self._ring), n))

    def clear(self) -> None:
        self._ring.clear()

    def spans_for_trace(self, trace_id: str) -> list:
        return [s for s in self._ring if s.trace_id == trace_id]

    # -- export ------------------------------------------------------------
    def chrome_trace(self, trace_id: str | None = None) -> dict:
        """Chrome trace-event JSON (Perfetto-loadable).  Complete events
        ("ph": "X") with microsecond ``ts`` offsets on the monotonic
        perf_counter timeline, sorted ascending, plus one metadata event
        anchoring the wall clock."""
        spans = self.snapshot()
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        spans.sort(key=lambda s: s.t0)
        events = [{
            "name": "clock_sync", "ph": "i", "s": "g",
            "ts": 0.0, "pid": _PID, "tid": 0,
            "args": {"wall_time_at_ts0": _EPOCH_WALL,
                     "capacity": self.capacity,
                     "n_recorded": self.n_recorded},
        }]
        for s in spans:
            t1 = s.t1 if s.t1 is not None else s.t0
            args = {"trace": s.trace_id, "span": s.span_id}
            if s.parent_id:
                args["parent"] = s.parent_id
            if s.attrs:
                args.update(s.attrs)
            events.append({
                "name": s.name,
                "cat": s.name.split(".", 1)[0],
                "ph": "X",
                "ts": round((s.t0 - _EPOCH_PERF) * 1e6, 3),
                "dur": round(max(t1 - s.t0, 0.0) * 1e6, 3),
                "pid": _PID,
                "tid": s.tid,
                "args": args,
            })
        # per-program dispatch counter tracks of the cost observatory
        # ride in every dump, beside the span timeline
        from . import profiler as _profiler

        events.extend(_profiler.counter_events(_EPOCH_PERF, _PID))
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def chrome_trace_json(self, trace_id: str | None = None) -> str:
        return json.dumps(self.chrome_trace(trace_id), default=str)

    def dump(self, path: str | None = None, reason: str = "manual") -> str | None:
        """Write the Chrome trace to ``path`` (default: a fresh file in
        ``PATHWAY_TRACE_DUMP_DIR`` or the system tmpdir).  Returns the
        path, or None on write failure (dumping must never take the
        process down with it)."""
        if path is None:
            import tempfile

            d = os.environ.get("PATHWAY_TRACE_DUMP_DIR") or tempfile.gettempdir()
            path = os.path.join(
                d, f"pathway_trace_{_PID}_{reason}_{int(time.time())}.json"
            )
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            with open(path, "w", encoding="utf-8") as fh:
                fh.write(self.chrome_trace_json())
        except OSError:
            _log.warning("flight recorder: cannot write dump to %s", path)
            return None
        self.last_dump_path = path
        return path

    def dump_on_failure(self, reason: str, exc: BaseException | None = None
                        ) -> str | None:
        """Crash-path dump (engine failure): capped per process so a
        failure loop cannot fill the disk with trace files."""
        self.failure_dumps += 1
        if self.failure_dumps > _MAX_FAILURE_DUMPS:
            return None
        path = self.dump(reason=reason)
        if path:
            _log.warning(
                "flight recorder: dumped %d spans to %s after %s (%s)",
                len(self._ring), path, reason, exc,
            )
        return path


_RECORDER = FlightRecorder()
_signal_installed = False


def recorder() -> FlightRecorder:
    """The process-global flight recorder (installs the SIGUSR1 dump
    handler on first MAIN-THREAD touch, when safe)."""
    global _signal_installed
    if not _signal_installed and \
            threading.current_thread() is threading.main_thread():
        # only latch the flag on a main-thread attempt: a first touch
        # from a worker thread (e.g. an HTTP /debug/trace handler) must
        # not permanently disable the signal hook
        _signal_installed = True
        _install_sigusr1()
    return _RECORDER


def _install_sigusr1() -> None:
    """SIGUSR1 -> dump the flight recorder.  Only replaces the DEFAULT
    disposition (which would kill the process anyway); a host
    application's own handler is left alone."""
    import signal

    try:
        if signal.getsignal(signal.SIGUSR1) is signal.SIG_DFL:
            signal.signal(
                signal.SIGUSR1,
                lambda _sig, _frm: _RECORDER.dump(reason="sigusr1"),
            )
    except (ValueError, OSError, AttributeError):
        pass  # platform without SIGUSR1 (or non-main-thread race)


# -- context propagation ---------------------------------------------------

def current_context() -> tuple | None:
    """(trace_id, span_id) of the innermost open span, or None."""
    return _current.get()


def set_current(ctx: tuple | None):
    """Low-level: set the ambient context; returns the reset token."""
    return _current.set(ctx)


def reset_current(token) -> None:
    _current.reset(token)


class use_context:
    """Adopt a cross-thread context: spans opened inside parent to it."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: tuple | None):
        self._ctx = ctx

    def __enter__(self):
        self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _current.reset(self._token)


def start_span(name: str, ctx: tuple | None = None, **attrs) -> Span:
    """Open a span WITHOUT touching the ambient context (the cross-thread
    / long-lived form; caller owns ``finish()``).  ``ctx`` is an explicit
    parent context; when omitted the ambient context applies; when
    neither exists a fresh trace is minted — "a trace id is minted at
    admission"."""
    if ctx is None:
        ctx = _current.get()
    if ctx is None:
        return Span(name, new_trace_id(), 0, attrs or None)
    return Span(name, ctx[0], ctx[1], attrs or None)


class span:
    """Context manager form: parents to the ambient context, makes itself
    ambient for the body, records on exit (error type attached)."""

    __slots__ = ("_name", "_attrs", "_span", "_token")

    def __init__(self, name: str, **attrs):
        self._name = name
        self._attrs = attrs

    def __enter__(self) -> Span:
        self._span = start_span(self._name, **self._attrs)
        self._token = _current.set(self._span.ctx)
        return self._span

    def __exit__(self, exc_type, exc, _tb):
        _current.reset(self._token)
        if exc_type is not None:
            self._span.finish(error=exc_type.__name__)
        else:
            self._span.finish()


def record_span(name: str, t0: float, t1: float, ctx: tuple | None = None,
                **attrs) -> Span:
    """Retroactively record an interval measured by the caller (the
    hot-loop idiom: no context-manager entry/exit inside the loop, one
    recorder touch per interval)."""
    if ctx is None:
        ctx = _current.get()
    if ctx is None:
        ctx = (new_trace_id(), 0)
    s = Span.__new__(Span)
    s.name = name
    s.trace_id = ctx[0]
    s.span_id = next(_span_ids)
    s.parent_id = ctx[1]
    s.t0 = t0
    s.t1 = t1
    s.tid = threading.get_ident()
    s.attrs = attrs or None
    _RECORDER.record(s)
    return s


def event(name: str, ctx: tuple | None = None, **attrs) -> Span:
    """Instant (zero-duration) event."""
    now = time.perf_counter()
    return record_span(name, now, now, ctx=ctx, **attrs)


class disabled:
    """Context manager: suppress recording (the bench's overhead A/B)."""

    def __enter__(self):
        self._prev = _RECORDER.enabled
        _RECORDER.enabled = False
        return self

    def __exit__(self, *exc):
        _RECORDER.enabled = self._prev


# -- OTLP export + background flusher --------------------------------------

def _otlp_trace_id(trace_id: str) -> str:
    """OTLP wants 32 hex chars; our ids are short hex-ish strings."""
    h = "".join(c for c in trace_id if c in "0123456789abcdefABCDEF")
    if not h:
        h = trace_id.encode().hex()
    return (h * (32 // max(len(h), 1) + 1))[:32].lower()


_RESOURCE = {
    "attributes": [
        {"key": "service.name", "value": {"stringValue": "pathway-tpu"}},
    ]
}


def _post_json(url: str, payload: dict) -> None:
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    urllib.request.urlopen(req, timeout=10).read()


def export_otlp(endpoint: str, spans: list) -> None:
    """Push finished spans as OTLP/HTTP JSON traces with the REAL
    per-request trace ids, so a collector stitches the serving spans into
    one distributed trace (the reference's wire shape and resource)."""
    if not spans:
        return
    otlp = []
    for s in spans:
        otlp.append({
            "traceId": _otlp_trace_id(s.trace_id),
            "spanId": f"{s.span_id & 0xFFFFFFFFFFFFFFFF:016x}",
            "parentSpanId": (
                f"{s.parent_id & 0xFFFFFFFFFFFFFFFF:016x}"
                if s.parent_id else ""
            ),
            "name": s.name,
            "kind": 1,  # SPAN_KIND_INTERNAL
            "startTimeUnixNano": str(int(
                (_EPOCH_WALL + (s.t0 - _EPOCH_PERF)) * 1e9
            )),
            "endTimeUnixNano": str(int(
                (_EPOCH_WALL + ((s.t1 or s.t0) - _EPOCH_PERF)) * 1e9
            )),
            "attributes": [
                {"key": k, "value": {"stringValue": str(v)}}
                for k, v in (s.attrs or {}).items()
            ],
        })
    _post_json(
        endpoint.rstrip("/") + "/v1/traces",
        {"resourceSpans": [{
            "resource": _RESOURCE,
            "scopeSpans": [{
                "scope": {"name": "pathway_tpu_torch.obs"},
                "spans": otlp,
            }],
        }]},
    )


def _export_via_otel_sdk(spans: list) -> bool:
    """When a REAL opentelemetry SDK tracer provider is configured,
    replay finished spans through it (the collector/processor pipeline
    the host app set up).  Returns False when only the no-op API shim is
    present — opentelemetry-api is a common transitive dependency whose
    default ProxyTracer would silently swallow every span, so the caller
    must fall back to the raw OTLP JSON push."""
    try:
        from opentelemetry import trace as _ot
        from opentelemetry.sdk.trace import TracerProvider as _SdkProvider

        if not isinstance(_ot.get_tracer_provider(), _SdkProvider):
            return False
    except Exception:
        return False
    tracer = _ot.get_tracer("pathway_tpu_torch.obs")
    for s in spans:
        try:
            otspan = tracer.start_span(
                s.name,
                start_time=int((_EPOCH_WALL + (s.t0 - _EPOCH_PERF)) * 1e9),
            )
            for k, v in (s.attrs or {}).items():
                otspan.set_attribute(k, str(v))
            otspan.set_attribute("pathway.trace", s.trace_id)
            otspan.end(int((_EPOCH_WALL + ((s.t1 or s.t0) - _EPOCH_PERF)) * 1e9))
        except Exception:  # noqa: BLE001 - one bad span must not drop
            continue  # the rest of the batch
    return True


class _Flusher(threading.Thread):
    """Periodic exporter.  The cursor counts RECORDED spans (the ring
    appends in finish order), not span ids — span ids are assigned at
    span START, so a long-lived root (http.request, engine.run) that
    finishes after thousands of hot-loop children would be skipped
    forever by an id-based cursor."""

    def __init__(self, interval_s: float, endpoint: str | None):
        super().__init__(daemon=True, name="pw-obs-flusher")
        self.interval_s = interval_s
        self.endpoint = endpoint
        self._stop_evt = threading.Event()
        self._cursor = _RECORDER.n_recorded

    def flush_once(self) -> int:
        recorded = _RECORDER.n_recorded
        fresh = recorded - self._cursor
        if fresh <= 0:
            return 0
        self._cursor = recorded
        ring = _RECORDER.snapshot()
        # spans recorded since the last flush are the ring's tail; if
        # more arrived than the ring holds, the overflow was evicted
        spans = ring[-fresh:] if fresh < len(ring) else ring
        if not _export_via_otel_sdk(spans) and self.endpoint:
            try:
                export_otlp(self.endpoint, spans)
            except Exception:  # noqa: BLE001 - collector down != serving down
                _log.debug("obs flusher: OTLP export failed", exc_info=True)
        return len(spans)

    def run(self) -> None:
        while not self._stop_evt.wait(self.interval_s):
            self.flush_once()
        self.flush_once()  # final drain so shutdown loses nothing

    def stop(self, timeout_s: float = 5.0) -> None:
        self._stop_evt.set()
        self.join(timeout=timeout_s)


_flusher: _Flusher | None = None
_flusher_lock = threading.Lock()


def start_flusher(interval_s: float = 5.0, endpoint: str | None = None
                  ) -> _Flusher:
    """Start (or return) the background span flusher.  Tests and
    shutdown paths MUST pair this with :func:`shutdown` — a dangling
    flusher thread flakes ``--continue-on-collection-errors`` runs."""
    global _flusher
    with _flusher_lock:
        if _flusher is None or not _flusher.is_alive():
            _flusher = _Flusher(
                interval_s,
                endpoint or os.environ.get("PATHWAY_MONITORING_SERVER"),
            )
            _flusher.start()
        return _flusher


def shutdown(timeout_s: float = 5.0) -> None:
    """Stop the background flusher (final drain included).  Idempotent;
    registered atexit so a process never exits with the thread running."""
    global _flusher
    with _flusher_lock:
        fl = _flusher
        _flusher = None
    if fl is not None and fl.is_alive():
        fl.stop(timeout_s)


import atexit  # noqa: E402  (registration belongs with shutdown)

atexit.register(shutdown)


def maybe_start_flusher_from_env() -> None:
    """Auto-start the flusher only when an export target is configured —
    an unconfigured process must not pay a wakeup loop for nothing."""
    if os.environ.get("PATHWAY_MONITORING_SERVER"):
        start_flusher()
