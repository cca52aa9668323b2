"""Admission control: bounded queues, overflow policy, per-class rate limits.

The port's copy of ``pathway_tpu/serve/admission.py``.  An
:class:`AdmissionController` sits between a transport and its work queue
and applies one of three policies when the system is saturated:

- ``block``   — the caller waits (bounded by ``block_timeout_s``);
- ``shed``    — raise :class:`ShedError` carrying a ``retry_after_s``
  hint (an HTTP front maps it to ``429`` + ``Retry-After``);
- ``degrade`` — the caller runs a cheaper tier instead of dropping the
  request.

A token bucket per :class:`Priority` class bounds sustained request rates
independently of queue capacity.  :class:`EngineFailedError` is the
decode engine's typed failure (an HTTP front maps it to ``503``).
"""

from __future__ import annotations

import enum
import threading
import time

from .metrics import serve_stats


class Priority(enum.IntEnum):
    """Request priority classes — lower value schedules first."""

    HIGH = 0
    NORMAL = 1
    LOW = 2

    @classmethod
    def parse(cls, value) -> "Priority":
        """Accept a Priority, an int, or a (case-insensitive) name."""
        if isinstance(value, cls):
            return value
        if isinstance(value, int):
            return cls(value)
        if isinstance(value, str):
            try:
                return cls[value.strip().upper()]
            except KeyError:
                pass
        raise ValueError(f"unknown priority {value!r}")


class ShedError(Exception):
    """Request rejected by admission control; carries the Retry-After hint."""

    def __init__(self, reason: str, retry_after_s: float = 1.0):
        super().__init__(reason)
        self.retry_after_s = max(0.0, float(retry_after_s))


class QueueFullError(ShedError):
    pass


class RateLimitedError(ShedError):
    pass


class DeadlineExceededError(ShedError):
    """The request's deadline passed before it could execute."""

    def __init__(self, reason: str = "deadline exceeded before execution",
                 retry_after_s: float = 0.0):
        super().__init__(reason, retry_after_s)


class SchedulerClosedError(ShedError):
    def __init__(self, reason: str = "scheduler is shut down"):
        super().__init__(reason, retry_after_s=0.0)


class EngineFailedError(RuntimeError):
    """A request died because the decode engine failed and its restart
    budget, if any, ran out.  Admission rejected nothing; the device tier
    broke.  An HTTP front maps it to ``503 + Retry-After``.

    Attributes: ``retry_after_s`` (hint for the 503), ``trace_id`` (the
    engine run that failed) and ``dump_path`` (a flight-recorder dump of
    the failure, when one was written)."""

    def __init__(self, reason: str, *, retry_after_s: float = 5.0,
                 trace_id: str | None = None, dump_path: str | None = None):
        super().__init__(reason)
        self.retry_after_s = max(0.0, float(retry_after_s))
        self.trace_id = trace_id
        self.dump_path = dump_path


class AdmissionPolicy(str, enum.Enum):
    BLOCK = "block"
    SHED = "shed"
    DEGRADE = "degrade"

    @classmethod
    def parse(cls, value) -> "AdmissionPolicy":
        if isinstance(value, cls):
            return value
        return cls(str(value).lower())


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill, `burst` capacity.

    ``try_acquire`` is non-blocking; ``time_to_token`` is the Retry-After
    hint when it fails.  Monotonic-clock based and thread-safe.
    """

    def __init__(self, rate: float, burst: float | None = None):
        if rate <= 0:
            raise ValueError("rate must be positive")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(1.0, rate))
        self._tokens = self.burst
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        self._tokens = min(self.burst, self._tokens + (now - self._last) * self.rate)
        self._last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill(time.monotonic())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def time_to_token(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (0 when they are)."""
        with self._lock:
            self._refill(time.monotonic())
            missing = n - self._tokens
            return max(0.0, missing / self.rate)

    def acquire(self, n: float = 1.0, timeout_s: float | None = None) -> bool:
        """Blocking acquire; returns False on timeout."""
        deadline = (time.monotonic() + timeout_s) if timeout_s is not None else None
        while True:
            if self.try_acquire(n):
                return True
            wait = self.time_to_token(n)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                wait = min(wait, remaining)
            time.sleep(max(wait, 1e-4))


def _normalize_rate_limits(rate_limits) -> dict[Priority, TokenBucket]:
    """{Priority|name: TokenBucket | rate | (rate, burst)} -> buckets."""
    out: dict[Priority, TokenBucket] = {}
    for key, spec in (rate_limits or {}).items():
        prio = Priority.parse(key)
        if isinstance(spec, TokenBucket):
            out[prio] = spec
        elif isinstance(spec, (tuple, list)):
            out[prio] = TokenBucket(*spec)
        else:
            out[prio] = TokenBucket(float(spec))
    return out


class AdmissionController:
    """Bounded-admission gate for a serving entry point.

    Args:
        max_pending: in-flight + queued requests admitted at once.
        policy: overflow behavior (``block`` / ``shed`` / ``degrade``).
        rate_limits: optional ``{priority: rate | (rate, burst) |
            TokenBucket}`` sustained-rate bounds per priority class.
        block_timeout_s: how long ``block`` waits before shedding anyway.
        retry_after_s: base Retry-After hint for queue-full sheds.
        name: the stats block's name (``serve.metrics.serve_stats``).
    """

    def __init__(
        self,
        *,
        max_pending: int = 64,
        policy: AdmissionPolicy | str = AdmissionPolicy.SHED,
        rate_limits=None,
        block_timeout_s: float = 5.0,
        retry_after_s: float = 1.0,
        name: str = "rest",
    ):
        self.max_pending = int(max_pending)
        self.policy = AdmissionPolicy.parse(policy)
        self.block_timeout_s = block_timeout_s
        self.retry_after_s = retry_after_s
        self.name = name
        self._buckets = _normalize_rate_limits(rate_limits)
        self._pending = 0
        self._cond = threading.Condition()
        self.stats = serve_stats(name, depth_fn=lambda: self._pending)

    @property
    def pending(self) -> int:
        return self._pending

    def _rate_check(self, priority: Priority) -> None:
        bucket = self._buckets.get(priority)
        if bucket is None:
            return
        if self.policy is AdmissionPolicy.BLOCK:
            if bucket.acquire(timeout_s=self.block_timeout_s):
                return
            self.stats.record_shed("rate_limit")
            raise RateLimitedError(
                f"rate limit for {priority.name} traffic exceeded",
                retry_after_s=bucket.time_to_token(),
            )
        if not bucket.try_acquire():
            self.stats.record_shed("rate_limit")
            raise RateLimitedError(
                f"rate limit for {priority.name} traffic exceeded",
                retry_after_s=max(bucket.time_to_token(), 0.05),
            )

    def try_acquire(self, priority: Priority | str | int = Priority.NORMAL,
                    *, will_degrade: bool = False) -> None:
        """Admit one request or raise ShedError.  ``degrade`` policy raises
        too — the caller catches QueueFullError and runs its cheaper tier
        (then records via :meth:`record_degraded`).  Such callers pass
        ``will_degrade=True`` so the overflow is counted ONLY as degraded,
        never double-counted as a shed (the request is still answered)."""
        priority = Priority.parse(priority)
        self._rate_check(priority)
        with self._cond:
            if self._pending < self.max_pending:
                self._pending += 1
                self.stats.record_admitted()
                return
            if self.policy is AdmissionPolicy.BLOCK:
                deadline = time.monotonic() + self.block_timeout_s
                while self._pending >= self.max_pending:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(remaining):
                        break
                if self._pending < self.max_pending:
                    self._pending += 1
                    self.stats.record_admitted()
                    return
        if not will_degrade:
            self.stats.record_shed("queue_full")
        raise QueueFullError(
            f"admission queue full ({self.max_pending} pending)",
            retry_after_s=self.retry_after_s,
        )

    def release(self, *, completed: bool = True) -> None:
        with self._cond:
            self._pending = max(0, self._pending - 1)
            self._cond.notify()
        if completed:
            self.stats.record_completed()

    def record_degraded(self) -> None:
        self.stats.record_degraded()

    def __enter__(self):
        self.try_acquire()
        return self

    def __exit__(self, exc_type, *exc):
        self.release(completed=exc_type is None)


__all__ = [
    "AdmissionController", "AdmissionPolicy", "DeadlineExceededError",
    "EngineFailedError", "Priority", "QueueFullError", "RateLimitedError",
    "SchedulerClosedError", "ShedError", "TokenBucket",
]
