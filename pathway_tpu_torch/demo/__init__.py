"""pw.demo — synthetic stream generators (the port of ``pathway_tpu/demo``;
reference: demo/__init__.py:29).  The streams run through the port's
``io.python`` in ``pw.run(device=...)``.

Five public helpers mirror the reference module's surface exactly:
``generate_custom_stream`` (index-driven column generators),
``noisy_linear_stream`` / ``range_stream`` (canonical tutorial streams),
``replay_csv`` (fixed-rate file replay) and ``replay_csv_with_time``
(timestamp-paced replay honoring inter-row gaps from a time column).
"""

from __future__ import annotations

import csv as _csv
import time
from typing import Any, Callable

from ..internals.schema import SchemaMetaclass, schema_from_types
from ..internals.table import Table
from ..io import python as io_python


def generate_custom_stream(
    value_generators: dict[str, Callable[[int], Any]],
    *,
    schema: SchemaMetaclass,
    nb_rows: int | None = None,
    input_rate: float = 1.0,
    autocommit_duration_ms: int = 1000,
    persistent_id: str | None = None,
    name: str | None = None,
    deterministic: bool = False,
) -> Table:
    """Generate a data stream from per-column index functions.

    Rows are generated iteratively with an index ``i`` starting from 0;
    each column's value is ``value_generators[col](i)``.  With
    ``nb_rows=None`` the stream never ends; otherwise exactly ``nb_rows``
    rows are produced at ``input_rate`` rows/second.

    ``deterministic=True`` declares the generators pure functions of the
    index, opting the stream into the persistence prefix-skip so restarts
    stay exactly-once (the default stays False because caller-supplied
    generators may be stateful — see io.python.ConnectorSubject).

    Reference: demo/__init__.py:29 (same semantics incl. the nb_rows
    validation)."""
    if nb_rows is not None and nb_rows < 0:
        raise ValueError(
            "demo.generate_custom_stream error: nb_rows should be None "
            "or strictly positive."
        )
    _det = deterministic

    class Subject(io_python.ConnectorSubject):
        deterministic_rerun = _det

        def run(self):
            i = 0
            while nb_rows is None or i < nb_rows:
                row = {name: gen(i) for name, gen in value_generators.items()}
                self.next(**row)
                i += 1
                if input_rate > 0:
                    time.sleep(1.0 / input_rate)

    return io_python.read(Subject(), schema=schema,
                          autocommit_duration_ms=autocommit_duration_ms,
                          name=name or "demo.custom-stream",
                          persistent_id=persistent_id)


def range_stream(nb_rows: int | None = None, offset: int = 0,
                 input_rate: float = 1.0, **kwargs) -> Table:
    """Stream of consecutive integers in a single ``value`` column,
    starting at ``offset`` (reference: demo/__init__.py:165).  Pure
    index-based, so restarts under persistence are exactly-once."""
    schema = schema_from_types(value=int)
    return generate_custom_stream(
        {"value": lambda i: i + offset}, schema=schema, nb_rows=nb_rows,
        input_rate=input_rate, deterministic=True,
    )


def noisy_linear_stream(nb_rows: int = 10, input_rate: float = 1.0,
                        **kwargs) -> Table:
    """Stream of (x, y) points roughly on the y=x line with +-1 uniform
    noise — the linear-regression tutorial feed (reference:
    demo/__init__.py:118)."""
    import random

    schema = schema_from_types(x=float, y=float)
    return generate_custom_stream(
        {"x": lambda i: float(i), "y": lambda i: i + random.uniform(-1, 1)},
        schema=schema, nb_rows=nb_rows, input_rate=input_rate,
    )


def replay_csv(path: str, *, schema: SchemaMetaclass,
               input_rate: float = 1.0) -> Table:
    """Replay a static CSV file as a stream at a fixed ``input_rate``
    rows/second (reference: demo/__init__.py:212).  Standard CSV settings:
    ',' separator, '"' quotechar, no escape."""
    class Subject(io_python.ConnectorSubject):
        # re-reading the same file re-emits the same stream, so the
        # persistence prefix-skip is safe here (opt-in since r5)
        deterministic_rerun = True

        def run(self):
            with open(path, newline="", encoding="utf-8") as f:
                for row in _csv.DictReader(f):
                    self.next(**row)
                    if input_rate > 0:
                        time.sleep(1.0 / input_rate)

    return io_python.read(Subject(), schema=schema)


_UNIT_FACTORS = {"s": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}


def replay_csv_with_time(path: str, *, schema: SchemaMetaclass,
                         time_column: str, unit: str = "s",
                         autocommit_ms: int = 100,
                         speedup: float = 1) -> Table:
    """Replay a CSV file as a stream, PACING each row by the gaps in its
    ``time_column`` (ordered positive integer timestamps): a row stamped
    3 seconds after its predecessor is emitted ~3/speedup seconds later —
    unlike replay_csv's fixed rate (reference: demo/__init__.py:257)."""
    if unit not in _UNIT_FACTORS:
        raise ValueError(
            "demo.replay_csv_with_time: unit should be either 's', 'ms', "
            "'us', or 'ns'."
        )
    factor = _UNIT_FACTORS[unit] * float(speedup)

    class Subject(io_python.ConnectorSubject):
        deterministic_rerun = True  # same file -> same stream

        def run(self):
            prev_t: float | None = None
            with open(path, newline="", encoding="utf-8") as f:
                for row in _csv.DictReader(f):
                    t = float(row[time_column])
                    if prev_t is not None and t > prev_t:
                        time.sleep((t - prev_t) / factor)
                    prev_t = t
                    self.next(**row)

    return io_python.read(Subject(), schema=schema,
                          autocommit_duration_ms=autocommit_ms)
