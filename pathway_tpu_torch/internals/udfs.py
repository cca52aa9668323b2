"""UDF subsystem: @pw.udf with sync/async executors, caching, retries
(the port of ``pathway_tpu/internals/udfs.py``).

Reference: python/pathway/internals/udfs/ — executors.py:20-387,
caches.py:23-141, retries.py:42-107.  Async UDFs are evaluated per
micro-batch with asyncio gather (capacity-bounded); the fully-async
executor resolves rows as later updates (``engine/async_ops.py``).

The cache's key format (``"<name>:<hash_values(args, sorted kwargs)>"``)
and on-disk layout (one pickle of ``(value,)`` a key, named by the key's
SHA-256) are the JAX package's, so a :class:`DiskCache` directory written
by one package is read by the other.  A failing call poisons its row with
``ERROR`` and is recorded in the engine's error log; a cache fault
raises.
"""

from __future__ import annotations

import asyncio
import functools
import hashlib
import os
import pickle
import random
import tempfile
from typing import Any, Callable

from . import dtype as dt
from .expression import ApplyExpression, ColumnExpression, FullyAsyncApplyExpression
from .value import ERROR, hash_values


# ---------------------------------------------------------------------------
# retries
# ---------------------------------------------------------------------------

class AsyncRetryStrategy:
    async def invoke(self, fun, *args, **kwargs):
        return await fun(*args, **kwargs)


class NoRetryStrategy(AsyncRetryStrategy):
    pass


class ExponentialBackoffRetryStrategy(AsyncRetryStrategy):
    def __init__(self, max_retries: int = 3, initial_delay: int = 1000,
                 backoff_factor: float = 2, jitter_ms: int = 300):
        self.max_retries = max_retries
        self.initial_delay = initial_delay / 1000
        self.backoff_factor = backoff_factor
        self.jitter = jitter_ms / 1000

    async def invoke(self, fun, *args, **kwargs):
        delay = self.initial_delay
        for attempt in range(self.max_retries + 1):
            try:
                return await fun(*args, **kwargs)
            except Exception:
                if attempt == self.max_retries:
                    raise
                await asyncio.sleep(delay + random.random() * self.jitter)
                delay *= self.backoff_factor


class FixedDelayRetryStrategy(ExponentialBackoffRetryStrategy):
    def __init__(self, max_retries: int = 3, delay_ms: int = 1000):
        super().__init__(max_retries, delay_ms, 1, 0)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

class CacheStrategy:
    def lookup(self, key: str):
        return None

    def store(self, key: str, value) -> None:
        pass


class InMemoryCache(CacheStrategy):
    def __init__(self):
        self._data: dict[str, Any] = {}

    def lookup(self, key):
        return self._data.get(key)

    def store(self, key, value):
        self._data[key] = value


class DiskCache(CacheStrategy):
    """One file a key under ``directory`` (default:
    ``$PATHWAY_PERSISTENT_STORAGE/udf_cache``, else ``pathway_tpu/
    udf_cache`` in the temporary directory, where the JAX package's
    default lies).  Only a directory this program or the JAX package
    wrote should be given: its files are unpickled."""

    def __init__(self, directory: str | None = None):
        self.directory = directory or os.path.join(
            os.environ.get("PATHWAY_PERSISTENT_STORAGE",
                           os.path.join(tempfile.gettempdir(), "pathway_tpu")),
            "udf_cache")
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.directory,
                            hashlib.sha256(key.encode()).hexdigest())

    def lookup(self, key):
        p = self._path(key)
        if os.path.exists(p):
            with open(p, "rb") as f:
                return pickle.load(f)
        return None

    def store(self, key, value):
        with open(self._path(key), "wb") as f:
            pickle.dump(value, f)


DefaultCache = DiskCache


def _cache_key(name: str, args, kwargs) -> str:
    return f"{name}:{hash_values(tuple(args), tuple(sorted(kwargs.items())))}"


def with_cache_strategy(fun, cache: CacheStrategy, name: str):
    """``fun`` behind ``cache``: a hit returns the stored value, a miss
    calls ``fun`` and stores ``(value,)`` (so a stored None is a hit)."""
    @functools.wraps(fun)
    def wrapper(*args, **kwargs):
        key = _cache_key(name, args, kwargs)
        hit = cache.lookup(key)
        if hit is not None:
            return hit[0]
        value = fun(*args, **kwargs)
        cache.store(key, (value,))
        return value

    return wrapper


# ---------------------------------------------------------------------------
# executors
# ---------------------------------------------------------------------------

class Executor:
    def wrap(self, fun):
        return fun

    is_async = False


class SyncExecutor(Executor):
    pass


def sync_executor() -> SyncExecutor:
    return SyncExecutor()


class AsyncExecutor(Executor):
    is_async = True

    def __init__(self, capacity: int | None = None, timeout: float | None = None,
                 retry_strategy: AsyncRetryStrategy | None = None):
        self.capacity = capacity
        self.timeout = timeout
        self.retry_strategy = retry_strategy or NoRetryStrategy()


def async_executor(capacity=None, timeout=None, retry_strategy=None) -> AsyncExecutor:
    return AsyncExecutor(capacity, timeout, retry_strategy)


class FullyAsyncExecutor(AsyncExecutor):
    pass


def fully_async_executor(capacity=None, timeout=None, retry_strategy=None) -> FullyAsyncExecutor:
    return FullyAsyncExecutor(capacity, timeout, retry_strategy)


def run_coroutine_batch(coros: list, capacity: int | None = None) -> list:
    """Run a batch of coroutines on a private loop, bounded by capacity.
    Each returns its value or ERROR on failure."""

    async def runner():
        sem = asyncio.Semaphore(capacity) if capacity else None

        async def guarded(c):
            try:
                if sem is None:
                    return await c
                async with sem:
                    return await c
            except Exception as exc:
                from .expression import _record_error

                _record_error(exc, "async udf")
                return ERROR

        return await asyncio.gather(*[guarded(c) for c in coros])

    return asyncio.run(runner())


# ---------------------------------------------------------------------------
# @pw.udf
# ---------------------------------------------------------------------------

class UDF:
    """User-defined function usable in expressions (reference: pw.UDF).

    Subclass with __wrapped__ or use the @udf decorator.
    """

    def __init__(
        self,
        fun: Callable | None = None,
        *,
        return_type: Any = None,
        deterministic: bool = False,
        propagate_none: bool = False,
        executor: Executor | None = None,
        cache_strategy: CacheStrategy | None = None,
        max_batch_size: int | None = None,
    ):
        if fun is None and hasattr(self, "__wrapped__"):
            fun = self.__wrapped__
        self._fun = fun
        self._name = getattr(fun, "__name__", type(self).__name__)
        if return_type is None and fun is not None:
            hints = getattr(fun, "__annotations__", {})
            return_type = hints.get("return", dt.ANY)
        self._return_type = return_type if return_type is not None else dt.ANY
        self._deterministic = deterministic
        self._propagate_none = propagate_none
        if isinstance(executor, AutoExecutor):
            # resolve here (not only in @udf) so direct UDF construction
            # and __wrapped__ subclasses get the deduced executor too
            executor = (
                async_executor() if asyncio.iscoroutinefunction(fun)
                else sync_executor()
            )
        elif asyncio.iscoroutinefunction(fun) and not isinstance(
            executor, AsyncExecutor
        ):
            # a coroutine can only run on an async executor
            executor = async_executor()
        self._executor = executor or SyncExecutor()
        self._cache_strategy = cache_strategy
        self._max_batch_size = max_batch_size

        call_fun = fun
        if cache_strategy is not None and not isinstance(self._executor, AsyncExecutor):
            call_fun = with_cache_strategy(fun, cache_strategy, self._name)
        self._call_fun = call_fun

    @property
    def __name__(self):
        return self._name

    def __call__(self, *args, **kwargs) -> ColumnExpression:
        has_expr = any(isinstance(a, ColumnExpression) for a in args) or any(
            isinstance(v, ColumnExpression) for v in kwargs.values()
        )
        if not has_expr:
            return self._call_fun(*args, **kwargs)
        ex = self._executor
        if isinstance(ex, FullyAsyncExecutor):
            cls = FullyAsyncApplyExpression
        else:
            cls = ApplyExpression
        if isinstance(ex, AsyncExecutor):
            fun = self._make_async_batch_fun(ex)
            e = cls(
                fun,
                self._return_type,
                args,
                kwargs,
                propagate_none=self._propagate_none,
                deterministic=self._deterministic,
            )
            e._async_spec = (self._fun, ex, self._cache_strategy, self._name)
            return e
        return cls(
            self._call_fun,
            self._return_type,
            args,
            kwargs,
            propagate_none=self._propagate_none,
            deterministic=self._deterministic,
            max_batch_size=self._max_batch_size,
        )

    def _make_async_batch_fun(self, ex: AsyncExecutor):
        """Fallback sync bridge for async UDFs when evaluated row-by-row."""
        base = self._fun
        cache = self._cache_strategy
        name = self._name

        def fun(*args, **kwargs):
            async def one():
                if ex.timeout is not None:
                    return await asyncio.wait_for(
                        ex.retry_strategy.invoke(base, *args, **kwargs), ex.timeout
                    )
                return await ex.retry_strategy.invoke(base, *args, **kwargs)

            if cache is not None:
                key = _cache_key(name, args, kwargs)
                hit = cache.lookup(key)
                if hit is not None:
                    return hit[0]
                value = asyncio.run(one())
                cache.store(key, (value,))
                return value
            return asyncio.run(one())

        return fun


def udf(
    fun: Callable | None = None,
    /,
    *,
    return_type: Any = None,
    deterministic: bool = False,
    propagate_none: bool = False,
    executor: Executor | None = None,
    cache_strategy: CacheStrategy | None = None,
    max_batch_size: int | None = None,
):
    """Decorator: turn a Python function into a column-expression UDF."""

    def make(f):
        # AutoExecutor / coroutine deduction happens in UDF.__init__ so
        # every construction path (decorator, direct, __wrapped__ subclass)
        # resolves identically
        ex = executor
        return UDF(
            f,
            return_type=return_type,
            deterministic=deterministic,
            propagate_none=propagate_none,
            executor=ex,
            cache_strategy=cache_strategy,
            max_batch_size=max_batch_size,
        )

    if fun is None:
        return make
    return make(fun)


def async_apply_expression(fun, args, kwargs):
    u = udf(fun)
    return u(*args, **kwargs)


# compat names mirrored from the reference udfs module
async_options = async_executor


def coerce_async(func):
    """Wrap a regular function as a coroutine (reference: udfs/utils.py
    coerce_async); coroutine functions pass through unchanged."""
    if asyncio.iscoroutinefunction(func):
        return func

    @functools.wraps(func)
    async def wrapper(*args, **kwargs):
        return func(*args, **kwargs)

    return wrapper


def auto_executor() -> Executor:
    """Deduce sync vs async from the function signature at wrap time
    (reference: udfs/executors.py auto_executor)."""
    return AutoExecutor()


class AutoExecutor(Executor):
    """Marker resolved by @udf: coroutine functions get the async executor,
    plain functions the sync one."""


def with_capacity(func, capacity: int):
    """Bound concurrent invocations of an async (or auto-coerced) function
    with a semaphore (reference: udfs/executors.py:328).  The engine runs
    each micro-batch on a fresh event loop (async_ops.run_coroutine_batch),
    and asyncio primitives bind to the loop they first block on — so the
    semaphore is keyed per running loop."""
    import weakref

    func = coerce_async(func)
    per_loop: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()

    @functools.wraps(func)
    async def wrapper(*args, **kwargs):
        loop = asyncio.get_running_loop()
        sem = per_loop.get(loop)
        if sem is None:
            sem = per_loop[loop] = asyncio.Semaphore(capacity)
        async with sem:
            return await func(*args, **kwargs)

    return wrapper


def with_timeout(func, timeout: float):
    """Cancel the call and raise after `timeout` seconds
    (reference: udfs/executors.py:354)."""
    func = coerce_async(func)

    @functools.wraps(func)
    async def wrapper(*args, **kwargs):
        return await asyncio.wait_for(func(*args, **kwargs), timeout=timeout)

    return wrapper


def with_retry_strategy(func, retry_strategy: "AsyncRetryStrategy"):
    """Apply a retry strategy to an async (or auto-coerced) function
    (reference: udfs/retries.py:20)."""
    func = coerce_async(func)

    @functools.wraps(func)
    async def wrapper(*args, **kwargs):
        return await retry_strategy.invoke(func, *args, **kwargs)

    return wrapper


__all__ = [
    "AsyncExecutor", "AsyncRetryStrategy", "CacheStrategy", "DefaultCache",
    "DiskCache", "ExponentialBackoffRetryStrategy", "Executor",
    "FixedDelayRetryStrategy", "FullyAsyncExecutor", "InMemoryCache",
    "NoRetryStrategy", "SyncExecutor", "UDF", "async_executor",
    "async_options", "auto_executor", "coerce_async", "fully_async_executor",
    "sync_executor", "udf", "with_cache_strategy", "with_capacity",
    "with_retry_strategy", "with_timeout",
]
