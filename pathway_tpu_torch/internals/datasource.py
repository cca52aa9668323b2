"""Data sources feeding input nodes.

Reference: python/pathway/internals/datasource.py + the connector runtime
(src/connectors/mod.rs:614).  A DataSource provides either a static batch of
events (batch mode / stream replay) or a live poll interface (streaming mode).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable

from .value import Pointer, ref_scalar, sequential_pointer

Event = tuple[int, int, tuple, int]  # (time, key, row, diff)


class DataSource:
    """Base: static events + optional live polling."""

    append_only = False

    def static_events(self) -> list[Event]:
        return []

    def is_live(self) -> bool:
        return False

    def poll(self) -> list[Event] | None:
        """Live mode: new events since last poll; None = source finished."""
        return None

    def start(self) -> None:
        pass

    def stop(self) -> None:
        pass


class StaticDataSource(DataSource):
    def __init__(self, events: list[Event]):
        self._events = events

    def static_events(self) -> list[Event]:
        return self._events


class ColumnarStaticSource(DataSource):
    """Static source already in struct-of-arrays form: the engine ingests the
    ColumnarBatch directly — no per-row event tuples are ever built (the
    columnar input tier of SURVEY.md §7's design stance)."""

    def __init__(self, batches: list):
        self._batches = batches  # [(time, ColumnarBatch)]

    def static_batches(self) -> list:
        return self._batches

    def static_events(self) -> list[Event]:
        # compatibility materialization (cluster replicated injection,
        # persistence journaling)
        return [
            (t, key, row, diff)
            for t, b in self._batches
            for (key, row, diff) in b
        ]


def rows_to_events(
    rows: Iterable[tuple],
    colnames: list[str],
    primary_key_positions: list[int] | None = None,
    explicit_keys: Iterable[Pointer] | None = None,
    time: int = 0,
) -> list[Event]:
    events: list[Event] = []
    keys = list(explicit_keys) if explicit_keys is not None else None
    for i, row in enumerate(rows):
        row = tuple(row)
        if keys is not None:
            key = keys[i]
        elif primary_key_positions:
            key = ref_scalar(*[row[p] for p in primary_key_positions])
        else:
            key = sequential_pointer(i)
        events.append((time, key, row, 1))
    return events


class SubjectDataSource(DataSource):
    """Live source driven by a ConnectorSubject-style object running in a
    thread (reference: io/python ConnectorSubject, io/python/__init__.py:49).

    The subject calls `next(**values)` / `remove(**values)`; events are queued
    and drained by the engine's streaming loop.
    """

    def __init__(self, subject, colnames: list[str], primary_key_positions=None,
                 append_only: bool = True):
        self.subject = subject
        self.colnames = colnames
        self.pk_positions = primary_key_positions
        self.append_only = append_only
        self._queue: "queue.Queue[tuple[tuple, int, Any] | None]" = queue.Queue()
        self._thread: threading.Thread | None = None
        self._finished = False
        self._autokey = 0

    def is_live(self) -> bool:
        return True

    # -- subject-facing API -----------------------------------------------
    def push(self, row: tuple, diff: int, key=None) -> None:
        self._queue.put((row, diff, key))

    def close(self) -> None:
        self._queue.put(None)

    # -- engine-facing API -------------------------------------------------
    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run_subject, daemon=True, name="pw-source"
            )
            self._thread.start()

    def _run_subject(self) -> None:
        try:
            self.subject._run(self)
        finally:
            self.close()

    def poll(self) -> list[Event] | None:
        events: list[Event] = []
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                self._finished = True
                break
            row, diff, key = item
            if key is None:
                if self.pk_positions:
                    key = ref_scalar(*[row[p] for p in self.pk_positions])
                else:
                    key = sequential_pointer(self._autokey)
                    self._autokey += 1
            elif not isinstance(key, Pointer):
                key = ref_scalar(key)
            events.append((0, key, row, diff))  # time filled in by runner
        if not events and self._finished:
            return None
        return events

    def stop(self) -> None:
        self._finished = True

    # offset persistence delegates to the subject when it participates
    # (e.g. the airbyte subject's STATE frontier)
    def get_offsets(self) -> dict:
        fn = getattr(self.subject, "get_offsets", None)
        return fn() if fn is not None else {}

    def seek(self, offsets: dict) -> None:
        fn = getattr(self.subject, "seek", None)
        if fn is not None:
            fn(offsets)

    @property
    def replays_from_scratch(self) -> bool:
        """True when a restart re-emits already-consumed events: the
        persistence wrapper must skip the re-read prefix or journal replay
        double-ingests.  OPT-IN via the subject's `deterministic_rerun`
        flag (default False since r5, ADVICE r4) — broker-push subjects
        (mqtt/nats/rabbitmq/rest) only deliver NEW events after a restart,
        so skipping would eat real data.  Subjects that declare
        deterministic re-emission opt in (demo.replay_csv,
        demo.range_stream; io.http.read via its parameter); a subject with real
        seek support never needs the skip."""
        return (
            getattr(self.subject, "seek", None) is None
            and bool(getattr(self.subject, "deterministic_rerun", False))
        )
