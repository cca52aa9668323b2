"""Continuous-batching request scheduler.

The port of ``pathway_tpu/serve/scheduler.py``.  Concurrent callers
submit single work items (a text to embed, a prompt to answer); a
background worker coalesces whatever is queued into one batch — highest
priority first, FIFO within a class — and runs the whole batch through
``batch_fn`` in a single device/tier call.  Between the first item's
arrival and dispatch the worker lingers ``batch_linger_ms`` so a burst of
concurrent requests lands in one batch instead of N singleton calls.

Batch sizes can be padded up a bucket ladder (``size_buckets``,
``ops/_tiling.bucket_for``) so the device sees a bounded set of shapes;
padding repeats the final payload and the padded tail of the result is
dropped.

Admission is enforced at submit time: bounded queue depth with a
block/shed/degrade overflow policy and optional per-priority token-bucket
rate limits (serve/admission.py).  Per-request deadlines are honored
twice — an expired request is shed *before* execution rather than wasting
a batch slot, and a caller whose wait times out detaches so the worker
skips its slot.  Counters go to serve/metrics.py; each request's spans
go to the flight recorder (``obs``): a ``serve.request`` root minted at
submit (or continuing the ambient trace), ``serve.queue`` until its batch
forms, ``serve.execute`` for the batch call, and ``serve.batch`` on the
scheduler's own trace.  A paged engine's ``serve_batch`` reads the
executing waiters' traces, so its spans join the request's trace.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import Any, Callable, Sequence

from .. import obs
from ..ops._tiling import bucket_for
from .admission import (
    AdmissionPolicy,
    DeadlineExceededError,
    Priority,
    QueueFullError,
    RateLimitedError,
    SchedulerClosedError,
    _normalize_rate_limits,
)
from .metrics import serve_stats


class _Waiter:
    __slots__ = ("payload", "priority", "enqueued", "deadline", "event",
                 "result", "error", "seq", "cancelled", "trace",
                 "queue_span")

    def __init__(self, payload, priority: Priority, deadline: float | None,
                 seq: int):
        self.payload = payload
        self.priority = priority
        self.enqueued = time.monotonic()
        self.deadline = deadline
        self.event = threading.Event()
        self.result: Any = None
        self.error: BaseException | None = None
        self.seq = seq
        self.cancelled = False
        # the request's (trace_id, span_id) root context, captured at
        # submit so engine-side spans parent to it across threads; the
        # queue span closes when the request's batch forms
        self.trace: tuple | None = None
        self.queue_span = None

    def __lt__(self, other: "_Waiter") -> bool:
        return (self.priority, self.seq) < (other.priority, other.seq)


class RequestScheduler:
    """Coalesce concurrent single-item calls into batched ``batch_fn`` calls.

    Args:
        batch_fn: ``list[payload] -> list[result]`` — ONE device/tier call
            serving the whole batch; must return one result per payload
            (a per-item exception in a result slot fails that caller only).
        name: stats name; also the key for :func:`shared_scheduler`.
        max_batch_size: dispatch cap per device call.
        batch_linger_ms: how long the worker waits for stragglers once the
            first item of a batch arrives.  0 disables lingering.
        max_queue: queued-request bound — beyond it the admission policy
            applies.
        policy: ``shed`` (default; raise with Retry-After), ``block``
            (bounded wait for space), or ``degrade`` (run ``degrade_fn``
            instead).
        degrade_fn: cheaper single-item fallback for the ``degrade`` policy.
        rate_limits: ``{priority: rate | (rate, burst) | TokenBucket}``.
        size_buckets: optional batch-size ladder; batches are padded up to
            the next bucket to bound the shapes a device sees.
        default_deadline_s: deadline applied when submit() passes none.
        default_timeout_s: how long a caller waits for its result.
    """

    def __init__(
        self,
        batch_fn: Callable[[list], Sequence],
        *,
        name: str = "serve",
        max_batch_size: int = 32,
        batch_linger_ms: float = 2.0,
        max_queue: int = 256,
        policy: AdmissionPolicy | str = AdmissionPolicy.SHED,
        degrade_fn: Callable[[Any], Any] | None = None,
        rate_limits=None,
        size_buckets: Sequence[int] | None = None,
        default_deadline_s: float | None = None,
        default_timeout_s: float = 30.0,
        block_timeout_s: float = 5.0,
        retry_after_s: float = 1.0,
        start: bool = True,
    ):
        self.batch_fn = batch_fn
        self.name = name
        self.max_batch_size = int(max_batch_size)
        self.batch_linger_s = max(0.0, batch_linger_ms / 1000.0)
        self.max_queue = int(max_queue)
        self.policy = AdmissionPolicy.parse(policy)
        self.degrade_fn = degrade_fn
        self.size_buckets = tuple(size_buckets) if size_buckets else None
        self.default_deadline_s = default_deadline_s
        self.default_timeout_s = default_timeout_s
        self.block_timeout_s = block_timeout_s
        self.retry_after_s = retry_after_s
        self._buckets = _normalize_rate_limits(rate_limits)
        self._heap: list[_Waiter] = []
        self._cond = threading.Condition()
        self._seq = itertools.count()
        self._closed = False
        self._thread: threading.Thread | None = None
        self.stats = serve_stats(name, depth_fn=lambda: len(self._heap))
        # batch-formation spans (which cut across requests) land on the
        # scheduler's own trace
        self._obs_ctx = (obs.new_trace_id(), 0)
        # the waiters of the batch executing now (serve_batch reads their
        # traces)
        self._inflight_waiters: Sequence = ()
        if start:
            self.start()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._closed = False
            self._thread = threading.Thread(
                target=self._worker, daemon=True, name=f"pw-serve-{self.name}"
            )
            self._thread.start()

    def shutdown(self, *, drain: bool = True, timeout_s: float = 10.0) -> None:
        """Stop accepting work.  ``drain=True`` executes everything already
        queued before the worker exits; ``drain=False`` fails queued
        requests with SchedulerClosedError immediately."""
        with self._cond:
            self._closed = True
            if not drain:
                for w in self._heap:
                    w.error = SchedulerClosedError()
                    w.event.set()
                    self.stats.record_shed("closed")
                    if w.queue_span is not None:
                        w.queue_span.finish(outcome="closed")
                self._heap.clear()
            self._cond.notify_all()
        th = self._thread
        if th is not None:
            th.join(timeout=timeout_s)

    @property
    def queue_depth(self) -> int:
        return len(self._heap)

    # -- submission --------------------------------------------------------
    def submit(
        self,
        payload: Any,
        *,
        priority: Priority | str | int = Priority.NORMAL,
        deadline_s: float | None = None,
        timeout_s: float | None = None,
    ) -> Any:
        """Enqueue one item and block until its batched result arrives.

        Raises ShedError subclasses on admission rejection or deadline
        expiry; exceptions from ``batch_fn`` propagate to every caller in
        the failed batch."""
        priority = Priority.parse(priority)
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        if timeout_s is None:
            timeout_s = self.default_timeout_s
        # the request's root span: minted here, or continuing the ambient
        # trace; every queue/engine span of this request parents under it
        root = obs.start_span(
            "serve.request", scheduler=self.name, priority=priority.name,
        )
        try:
            waiter = self._admit(payload, priority, deadline_s,
                                 trace=root.ctx)
        except BaseException as exc:
            root.finish(outcome="shed", error=type(exc).__name__)
            raise
        if waiter is None:  # degraded
            obs.event("serve.degrade", ctx=root.ctx, scheduler=self.name)
            try:
                return self.degrade_fn(payload)
            finally:
                root.finish(outcome="degraded")
        wait_s = timeout_s
        if deadline_s is not None:
            wait_s = min(wait_s, deadline_s + 0.05)
        if not waiter.event.wait(wait_s):
            waiter.cancelled = True  # worker will skip the stale slot
            with self._cond:
                # a still-queued waiter frees its slot immediately so a
                # wedged batch_fn cannot fill max_queue with abandoned
                # entries; an already-popped waiter is mid-execution and
                # only detaches (its completion is not counted)
                in_heap = waiter in self._heap
                if in_heap:
                    self._heap.remove(waiter)
                    heapq.heapify(self._heap)
                    self._cond.notify_all()
            if in_heap:
                expired = (waiter.deadline is not None
                           and time.monotonic() >= waiter.deadline)
                self.stats.record_shed("deadline" if expired else "timeout")
                waiter.queue_span.finish(
                    outcome="shed_deadline" if expired else "shed_timeout")
            root.finish(outcome="timeout")
            raise DeadlineExceededError(
                f"request timed out after {wait_s:.2f}s in scheduler "
                f"{self.name!r}"
            )
        if waiter.error is not None:
            root.finish(outcome="error", error=type(waiter.error).__name__)
            raise waiter.error
        root.finish(outcome="done")
        return waiter.result

    def _admit(self, payload, priority: Priority, deadline_s: float | None,
               trace: tuple | None = None) -> _Waiter | None:
        if self._closed:
            self.stats.record_shed("closed")
            raise SchedulerClosedError()
        bucket = self._buckets.get(priority)
        if bucket is not None and not bucket.try_acquire():
            if self.policy is AdmissionPolicy.BLOCK:
                if not bucket.acquire(timeout_s=self.block_timeout_s):
                    self.stats.record_shed("rate_limit")
                    raise RateLimitedError(
                        f"rate limit for {priority.name} traffic exceeded",
                        retry_after_s=bucket.time_to_token(),
                    )
            elif self.policy is AdmissionPolicy.DEGRADE and self.degrade_fn:
                self.stats.record_degraded()
                return None
            else:
                self.stats.record_shed("rate_limit")
                raise RateLimitedError(
                    f"rate limit for {priority.name} traffic exceeded",
                    retry_after_s=max(bucket.time_to_token(), 0.05),
                )
        deadline = ((time.monotonic() + deadline_s)
                    if deadline_s is not None else None)
        with self._cond:
            if len(self._heap) >= self.max_queue:
                if self.policy is AdmissionPolicy.BLOCK:
                    limit = time.monotonic() + self.block_timeout_s
                    while len(self._heap) >= self.max_queue and not self._closed:
                        remaining = limit - time.monotonic()
                        if remaining <= 0 or not self._cond.wait(remaining):
                            break
                if len(self._heap) >= self.max_queue:
                    if self.policy is AdmissionPolicy.DEGRADE and self.degrade_fn:
                        self.stats.record_degraded()
                        return None
                    self.stats.record_shed("queue_full")
                    raise QueueFullError(
                        f"scheduler {self.name!r} queue full "
                        f"({self.max_queue} queued)",
                        retry_after_s=self.retry_after_s,
                    )
            if self._closed:
                self.stats.record_shed("closed")
                raise SchedulerClosedError()
            waiter = _Waiter(payload, priority, deadline, next(self._seq))
            waiter.trace = trace
            waiter.queue_span = obs.start_span(
                "serve.queue", ctx=trace, scheduler=self.name,
            )
            heapq.heappush(self._heap, waiter)
            self.stats.record_admitted()
            self._cond.notify_all()
        return waiter

    # -- worker ------------------------------------------------------------
    def _worker(self) -> None:
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            if batch:
                self._execute(batch)

    def _next_batch(self) -> list[_Waiter] | None:
        with self._cond:
            while not self._heap:
                if self._closed:
                    return None
                # untimed: every push and shutdown() notifies under _cond,
                # so an idle worker sleeps without periodic wakeups
                self._cond.wait()
            if self.batch_linger_s > 0 and len(self._heap) < self.max_batch_size:
                # continuous batch formation: give concurrent callers a
                # short window to land in THIS batch
                linger_until = time.monotonic() + self.batch_linger_s
                while len(self._heap) < self.max_batch_size:
                    remaining = linger_until - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            batch: list[_Waiter] = []
            while self._heap and len(batch) < self.max_batch_size:
                batch.append(heapq.heappop(self._heap))
            self._cond.notify_all()  # space freed for blocked submitters
        return self._shed_stale(batch)

    def _shed_stale(self, batch: list[_Waiter]) -> list[_Waiter]:
        # shed anything already over deadline or abandoned — before the
        # device call, so expired work never occupies a batch slot
        now = time.monotonic()
        live = []
        waited = 0.0
        for w in batch:
            if w.cancelled:
                # detached after the pop but before execution; its caller
                # found itself already out of the heap, so the shed is
                # recorded here
                self.stats.record_shed("timeout")
                if w.queue_span is not None:
                    w.queue_span.finish(outcome="abandoned")
                continue
            if w.deadline is not None and now > w.deadline:
                w.error = DeadlineExceededError()
                w.event.set()
                self.stats.record_shed("deadline")
                if w.queue_span is not None:
                    w.queue_span.finish(outcome="shed_deadline")
            else:
                # queue wait ends here: the request is in a forming batch,
                # or an in-flight batch admits it
                if w.queue_span is not None:
                    w.queue_span.finish(outcome="dispatched")
                waited += now - w.enqueued
                live.append(w)
        if live:
            # a batch's first requests and those an in-flight batch polls
            # alike: each request's wait is counted here, once
            self.stats.record_queue_wait(waited)
        return live

    # -- step-boundary admission (continuous batching for steppable tiers) --
    def poll_inflight(self, max_n: int) -> list[_Waiter]:
        """Pop up to ``max_n`` queued waiters for admission into an
        IN-FLIGHT batch at a step boundary — the continuous-batching hook
        for steppable execution tiers (kvcache/engine.py admits new
        sequences between decode steps).  Deadline/cancel shedding applies
        exactly as in normal batch formation.  The caller owns completion:
        finish each returned waiter with :meth:`complete_inflight` /
        :meth:`fail_inflight`."""
        if max_n <= 0:
            return []
        with self._cond:
            popped: list[_Waiter] = []
            while self._heap and len(popped) < max_n:
                popped.append(heapq.heappop(self._heap))
            if popped:
                self._cond.notify_all()  # space freed for blocked submitters
        return self._shed_stale(popped)

    def complete_inflight(self, waiter: _Waiter, result: Any) -> None:
        """Deliver a result for a waiter obtained via :meth:`poll_inflight`."""
        waiter.result = result
        waiter.event.set()
        self.stats.record_completed()

    def fail_inflight(self, waiter: _Waiter, error: BaseException) -> None:
        # like _execute's error path, a failed request is neither a
        # completion nor a shed: the admitted-vs-(completed+shed) gap is
        # the error count
        waiter.error = error
        waiter.event.set()

    def _pad(self, payloads: list) -> list:
        if self.size_buckets is None or not payloads:
            return payloads
        target = bucket_for(len(payloads), self.size_buckets)
        if target > len(payloads):
            payloads = payloads + [payloads[-1]] * (target - len(payloads))
        return payloads

    def _execute(self, batch: list[_Waiter]) -> None:
        n = len(batch)
        payloads = self._pad([w.payload for w in batch])
        tp0 = time.perf_counter()
        self._inflight_waiters = batch
        try:
            results = list(self.batch_fn(payloads))[:n]
            if len(results) < n:
                raise RuntimeError(
                    f"batch_fn returned {len(results)} results for {n} items"
                )
        except Exception as exc:  # noqa: BLE001 — propagate to every caller
            self.stats.record_batch(n)
            tp1 = time.perf_counter()
            obs.record_span("serve.batch", tp0, tp1, ctx=self._obs_ctx,
                            scheduler=self.name, n=n,
                            padded=len(payloads), error=type(exc).__name__)
            for w in batch:
                w.error = exc
                w.event.set()
                if w.trace is not None:
                    obs.record_span("serve.execute", tp0, tp1, ctx=w.trace,
                                    error=type(exc).__name__)
            return
        finally:
            self._inflight_waiters = ()
        self.stats.record_batch(n)
        tp1 = time.perf_counter()
        obs.record_span("serve.batch", tp0, tp1, ctx=self._obs_ctx,
                        scheduler=self.name, n=n, padded=len(payloads))
        for w in batch:
            if w.trace is not None:
                obs.record_span("serve.execute", tp0, tp1, ctx=w.trace)
        completed = 0
        for w, r in zip(batch, results):
            if isinstance(r, BaseException):
                # a per-item exception (one undecodable request in a
                # paged decode batch) fails just that caller
                w.error = r
                w.event.set()
                continue
            w.result = r
            w.event.set()
            # mid-execution detaches still count as completed: the device
            # did the work, and the caller recorded no shed (it was already
            # out of the heap) — admitted == completed + shed stays true
            completed += 1
        self.stats.record_completed(completed)


_shared: dict[str, RequestScheduler] = {}
_shared_lock = threading.Lock()


def shared_scheduler(name: str, batch_fn: Callable[[list], Sequence] | None = None,
                     **kwargs) -> RequestScheduler:
    """Process-wide named scheduler — the single shared executor for a
    model tier: every caller routes through one worker (and one device
    queue) instead of dispatching per call.  The first caller provides
    ``batch_fn``; later callers get the same instance."""
    with _shared_lock:
        sched = _shared.get(name)
        if sched is None or (sched._closed and batch_fn is not None):
            if batch_fn is None:
                raise KeyError(f"no shared scheduler {name!r} registered yet")
            sched = _shared[name] = RequestScheduler(
                batch_fn, name=name, **kwargs
            )
        return sched


__all__ = ["RequestScheduler", "shared_scheduler"]
