"""AsyncTransformer: Table -> Table asynchronous transformation with full
reference semantics (stdlib/utils/async_transformer.py:60-387).  The port
of ``pathway_tpu/stdlib/utils/async_transformer.py``:

  - its own feedback loop: the input table is subscribed, rows are invoked
    on a private asyncio loop, and results feed BACK into the graph through
    a connector source — so completions arrive as later updates without ever
    blocking the engine;
  - a status lifecycle: every input row immediately appears in
    ``output_table`` with Pending placeholders; on completion the row is
    upserted to its result with ``_async_status`` = "-SUCCESS-"/"-FAILURE-";
    ``finished`` (= output_table.await_futures()) holds only completed rows;
  - per-key ordering: a newer invocation for a key waits for the prior
    task of that key before its result is applied;
  - per-instance consistency: results for rows sharing an ``instance``
    value are applied grouped by logical time, in time order; a failure
    poisons the instance for as long as it has in-flight members — every
    member flushed while the instance entry is alive reports FAILURE
    (reference _Instance.correct, which is likewise dropped once the
    instance's pending deque drains);
  - options: capacity / timeout / retry_strategy / cache_strategy
    (``with_options``); with a cache strategy, re-invocations after a
    restart are served from the cache, which is what makes recovery of
    in-flight rows deterministic (reference UdfCaching persistence mode).
"""

from __future__ import annotations

import asyncio
import collections
import threading
from dataclasses import dataclass, field
from typing import Any, ClassVar

from ...internals import dtype as dt
from ...internals.schema import (ColumnDefinition, SchemaMetaclass,
                                 schema_from_columns)
from ...internals.table import Table
from ...internals.value import PENDING
from ...internals import udfs

_STATUS_COL = "_async_status"
_INSTANCE_COL = "_pw_instance"
_SUCCESS = "-SUCCESS-"
_FAILURE = "-FAILURE-"


@dataclass(frozen=True)
class _Entry:
    key: Any
    time: int
    is_addition: bool


@dataclass
class _Instance:
    pending: collections.deque = field(default_factory=collections.deque)
    finished: dict = field(default_factory=dict)
    buffer: list = field(default_factory=list)
    buffer_time: int | None = None
    correct: bool = True


class _AsyncSubject:
    """Bridges subscribe callbacks (engine thread) into a private asyncio
    loop and pushes results back through a SubjectDataSource."""

    def __init__(self, transformer: "AsyncTransformer"):
        self.t = transformer
        self._queue: "collections.deque" = collections.deque()
        self._wake = threading.Event()
        self._instances: dict[Any, _Instance] = collections.defaultdict(_Instance)
        self._tasks: dict[Any, asyncio.Task] = {}
        self._last_emitted: dict[Any, tuple] = {}
        self._time_finished: int | None = None
        self._input_done = False
        self._handle = None

    # -- engine-thread callbacks (from pw.io.subscribe) --------------------
    def on_change(self, key, row, time, is_addition) -> None:
        self._queue.append(("row", key, dict(row), time, is_addition))
        self._wake.set()

    def on_time_end(self, time) -> None:
        self._queue.append(("time", time))
        self._wake.set()

    def on_end(self) -> None:
        self._queue.append(("end",))
        self._wake.set()

    # -- subject thread ----------------------------------------------------
    def _run(self, handle) -> None:
        self._handle = handle
        self.t.open()
        try:
            asyncio.run(self._loop())
        finally:
            self.t.close()
            handle.close()

    async def _loop(self) -> None:
        out_cols = self.t.output_schema.column_names()
        invoke = self.t._wrapped_invoke()
        while True:
            while not self._queue:
                if self._input_done and not self._tasks:
                    return
                self._wake.clear()
                # idle-wait off the engine thread; tasks progress meanwhile
                await asyncio.get_event_loop().run_in_executor(
                    None, self._wake.wait, 0.05
                )
            msg = self._queue.popleft()
            if msg[0] == "end":
                self._input_done = True
                if self._tasks:
                    await asyncio.gather(*self._tasks.values(),
                                         return_exceptions=True)
                # final barrier: everything still buffered flushes
                self._on_time_end(1 << 62)
                return
            if msg[0] == "time":
                self._on_time_end(msg[1])
                continue
            _kind, key, row, time_, addition = msg
            instance = row.pop(_INSTANCE_COL, key)
            entry = _Entry(key=key, time=time_, is_addition=addition)
            self._instances[instance].pending.append(entry)
            previous = self._tasks.get(key)
            if addition:
                # the row shows up pending right away (output_table shape)
                self._emit_pending(key, out_cols)

            async def task(key=key, row=row, entry=entry, instance=instance,
                           previous=previous):
                result: Any
                if not entry.is_addition:
                    result = None
                else:
                    try:
                        result = await invoke(**row)
                        self.t._check_result(result)
                    except Exception as exc:
                        import logging

                        from ...internals.expression import _record_error

                        logging.getLogger(__name__).error(
                            "Exception in AsyncTransformer:", exc_info=True
                        )
                        _record_error(exc, type(self.t).__name__)
                        result = _FAILURE
                if previous is not None:
                    # the key's previous invocation settles first; a fault
                    # in it (not a failing invoke: that is a FAILURE row)
                    # propagates
                    await previous
                self._on_task_finished(entry, instance, result)
                # prune: a long stream must not retain one Task per key
                if self._tasks.get(key) is asyncio.current_task():
                    del self._tasks[key]

            self._tasks[key] = asyncio.get_event_loop().create_task(task())

    # -- instance bookkeeping (reference _maybe_produce_instance) ----------
    def _on_time_end(self, time_) -> None:
        self._time_finished = (
            time_ if self._time_finished is None
            else max(self._time_finished, time_)
        )
        for instance in list(self._instances):
            self._maybe_produce_instance(instance)

    def _on_task_finished(self, entry: _Entry, instance, result) -> None:
        data = self._instances[instance]
        data.finished[entry] = result
        self._maybe_produce_instance(instance)

    def _maybe_produce_instance(self, instance) -> None:
        data = self._instances[instance]
        while data.pending:
            entry = data.pending[0]
            if (
                self._time_finished is None
                or entry.time > self._time_finished
                or entry not in data.finished
            ):
                break
            if data.buffer_time != entry.time:
                self._flush_buffer(data)
                data.buffer_time = entry.time
            result = data.finished.pop(entry)
            if result == _FAILURE:
                data.correct = False
            data.buffer.append((entry, result))
            data.pending.popleft()
        if not data.pending or data.pending[0].time != data.buffer_time:
            self._flush_buffer(data)
        if not data.pending:
            self._instances.pop(instance, None)

    def _flush_buffer(self, data: _Instance) -> None:
        if not data.buffer:
            return
        out_cols = self.t.output_schema.column_names()
        for entry, result in data.buffer:
            if entry.is_addition and data.correct:
                row = tuple(result.get(c) for c in out_cols) + (_SUCCESS,)
                self._upsert(entry.key, row)
            elif entry.is_addition:
                # instance poisoned (or this row failed): FAILURE row
                row = tuple(None for _ in out_cols) + (_FAILURE,)
                self._upsert(entry.key, row)
            else:
                self._remove(entry.key)
        data.buffer.clear()

    # -- output emission ---------------------------------------------------
    def _emit_pending(self, key, out_cols) -> None:
        row = tuple(PENDING for _ in out_cols) + (PENDING,)
        self._upsert(key, row)

    def _upsert(self, key, row: tuple) -> None:
        old = self._last_emitted.get(key)
        if old == row:
            return
        if old is not None:
            self._handle.push(old, -1, key)
        self._handle.push(row, 1, key)
        self._last_emitted[key] = row

    def _remove(self, key) -> None:
        old = self._last_emitted.pop(key, None)
        if old is not None:
            self._handle.push(old, -1, key)


class _Result:
    """Backward-compat view bundle."""

    def __init__(self, successful, failed, finished):
        self.successful = successful
        self.failed = failed
        self.finished = finished
        self.result = successful


class AsyncTransformer:
    """Reference: pw.AsyncTransformer (stdlib/utils/async_transformer.py).

    Subclass with an ``output_schema`` class attribute and an async
    ``invoke(**input_columns) -> dict`` method."""

    output_schema: ClassVar[SchemaMetaclass]

    def __init__(self, input_table: Table, *, instance=None,
                 autocommit_duration_ms: int | None = 1500):
        assert self.output_schema is not None
        if instance is not None:
            input_table = input_table.with_columns(
                **{_INSTANCE_COL: instance}
            )
        self._has_instance = instance is not None
        self._input = input_table
        self._autocommit_duration_ms = autocommit_duration_ms
        self._capacity = None
        self._timeout = None
        self._retry_strategy = None
        self._cache_strategy = None

    # -- user hooks --------------------------------------------------------
    async def invoke(self, *args, **kwargs) -> dict:
        raise NotImplementedError

    def open(self) -> None:
        pass

    def close(self) -> None:
        pass

    def with_options(self, capacity=None, timeout=None, retry_strategy=None,
                     cache_strategy=None) -> "AsyncTransformer":
        self._capacity = capacity
        self._timeout = timeout
        self._retry_strategy = retry_strategy
        self._cache_strategy = cache_strategy
        return self

    # -- wiring ------------------------------------------------------------
    def _wrapped_invoke(self):
        base = self.invoke
        retry = self._retry_strategy or udfs.NoRetryStrategy()
        timeout = self._timeout
        cache = self._cache_strategy
        sem = (
            asyncio.Semaphore(self._capacity) if self._capacity else None
        )
        name = f"async_transformer:{type(self).__name__}"

        async def call(**kwargs):
            if cache is not None:
                key = udfs._cache_key(name, (), kwargs)
                hit = cache.lookup(key)
                if hit is not None:
                    return hit[0]
            coro = retry.invoke(base, **kwargs)
            if timeout is not None:
                coro = asyncio.wait_for(coro, timeout)
            if sem is not None:
                async with sem:
                    value = await coro
            else:
                value = await coro
            if cache is not None:
                cache.store(key, (value,))
            return value

        return call

    def _check_result(self, result: dict) -> None:
        if not isinstance(result, dict) or set(result) != set(
            self.output_schema.column_names()
        ):
            raise ValueError(
                "result of async function does not match output schema"
            )

    @property
    def output_table(self) -> Table:
        """All rows that started execution; in-flight rows carry Pending
        placeholders, finished rows carry results + ``_async_status``."""
        if getattr(self, "_output_table", None) is None:
            self._output_table = self._build()
        return self._output_table

    @property
    def finished(self) -> Table:
        return self.output_table.await_futures()

    @property
    def successful(self) -> Table:
        f = self.finished
        ok = f.filter(f[_STATUS_COL] == _SUCCESS).without(_STATUS_COL)
        return ok.update_types(**self.output_schema.typehints())

    @property
    def failed(self) -> Table:
        f = self.finished
        return f.filter(f[_STATUS_COL] == _FAILURE).without(_STATUS_COL)

    @property
    def result(self) -> _Result:
        return _Result(self.successful, self.failed, self.finished)

    def _build(self) -> Table:
        from ...internals.datasource import SubjectDataSource
        from ...io._subscribe import subscribe
        from ...io._utils import make_input_table

        subject = _AsyncSubject(self)
        sub_node = subscribe(
            self._input,
            on_change=subject.on_change,
            on_time_end=subject.on_time_end,
            on_end=subject.on_end,
        )
        out_cols = self.output_schema.column_names()
        out_dtypes = self.output_schema.dtypes()
        colnames = out_cols + [_STATUS_COL]
        source = SubjectDataSource(subject, colnames, None, append_only=False)
        # the subscribe sink is this source's other half: any lowering that
        # includes the source must include it (engine/runner.py lower())
        source.companion_sinks = (sub_node,)
        wrapped = schema_from_columns(
            {
                **{
                    c: ColumnDefinition(
                        dtype=dt.Future(dt.Optional(out_dtypes[c]))
                    )
                    for c in out_cols
                },
                _STATUS_COL: ColumnDefinition(dtype=dt.Future(dt.STR)),
            },
            name=f"{type(self).__name__}Output",
        )
        return make_input_table(wrapped, source, name="async_transformer")
