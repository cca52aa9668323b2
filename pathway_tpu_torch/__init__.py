"""PyTorch/CUDA port of ``pathway_tpu``: the data plane and the RAG
serving path.

The data plane (``pw.Table``, expressions, the dataflow runner and its
operators, ``debug``, ``run``, ``io.subscribe``, ``io.fs``, ``io.csv``,
``io.jsonlines``, ``io.python``, ``io.http``'s REST connector, the
streaming sources and sinks (``io.kafka``, ``nats``, ``mqtt``,
``rabbitmq``, ``kinesis``, ``pubsub``), ``io.s3``, ``io.sqlite``, input
synchronization groups,
``stdlib.indexing``'s ``DataIndex``, the windows, temporal joins,
behaviors and sort of ``stdlib.temporal``, the stream and time
operators, ``pw.udf`` with its sync, async and fully-async executors,
``AsyncTransformer``, ``pw.iterate`` and ``pw.persistence``: input
journals, the replay modes, operator snapshots, the object cache and
exactly-once file sinks; ``pw.sql``, ``pw.transformer``, the universe
promises, ``pw.load_yaml``, ``LiveTable``, ``stdlib.graphs``, the HMM
reducer and the fuzzy join, ``pw.demo`` and the compat names, several
workers and processes — ``PATHWAY_THREADS`` shards and ``python -m
pathway_tpu_torch spawn`` clusters — with ``pw.run``'s monitoring, its
``/metrics`` server, OTLP export and the web dashboard) runs its
three device programs — the vectorized expression tier, the segment
reductions and the join membership (``engine/vectorize.py``,
``parallel/mapreduce.py``) — in PyTorch on the data plane's device.  The RAG pipeline
(``xpacks.llm``: the document store, the question answerers and their
REST servers) runs through that data plane.

The generation half (``kvcache.engine.PagedDecodeEngine`` over the paged
KV cache, greedy or seeded sampling, with supervised restart,
speculative decoding and optionally int8-resident weights;
``kvcache.statecache.StateDecodeEngine``, the constant-memory SSD
engine; ``models.decoder.TorchDecoderLM.generate`` over a dense cache;
``models.host_decoder.Int8DecoderHost``, the int8 host tier on the
CPU) and the retrieval half (``models.encoder.TorchEncoder`` plus
``stdlib.indexing.inner_index.BruteForceKnn``) run on one NVIDIA H100.
The four TPU kernels on that path are hand-written CUDA kernels under
``csrc/``, built with ``nvcc`` at first launch (``ops/_cuda.py``).

Row keys come from ``native/``: the JAX package's C++ hash source,
built with ``g++`` at first use, so a file read without a primary key
keys its rows as the JAX package does.  ``viz`` (and ``Table.show`` /
``plot`` / ``live_show``) is not ported: ``pw.viz`` raises naming the
ROADMAP item.

The package imports ``torch`` and nothing of JAX or ``pathway_tpu``;
module layout follows ``pathway_tpu`` so each module's counterpart is
found under the same path.  Entry points take ``device`` (default
``"cuda"``) and raise when no card is present unless ``device="cpu"``.
Importing the package initialises no CUDA context.
"""

from __future__ import annotations

from ._device import resolve_device, resolve_dtype
from .internals import dtype as _dt
from .internals import reducers
from .internals.dtype import DType
from .internals.expression import (
    ApplyExpression,
    CastExpression,
    CoalesceExpression,
    ColumnExpression,
    ColumnReference,
    ConvertExpression,
    FillErrorExpression,
    IfElseExpression,
    MakeTupleExpression,
    RequireExpression,
    unwrap_value,
    wrap,
)
from .internals.run import run, run_all
from .internals.schema import (
    ColumnDefinition,
    Schema,
    column_definition,
    schema_from_dict,
    schema_from_pandas,
    schema_from_types,
)
from .internals.table import GroupedTable, JoinResult, Table, Universe
from .internals.thisclass import left, right, this
from .internals.value import ERROR, PENDING, Json, Pointer

# -- dtype aliases (pw.INT etc. as in reference engine types) ---------------
INT = int
FLOAT = float
BOOL = bool
STR = str
BYTES = bytes
DATE_TIME_NAIVE = _dt.DATE_TIME_NAIVE
DATE_TIME_UTC = _dt.DATE_TIME_UTC
DURATION = _dt.DURATION


class JoinMode:
    INNER = "inner"
    LEFT = "left"
    RIGHT = "right"
    OUTER = "outer"


# -- expression constructors -------------------------------------------------
def apply(fun, *args, **kwargs) -> ApplyExpression:
    """Apply a Python function per row (reference: pw.apply)."""
    return ApplyExpression(fun, _dt.ANY, args, kwargs)


def apply_with_type(fun, ret_type, *args, **kwargs) -> ApplyExpression:
    return ApplyExpression(fun, ret_type, args, kwargs)


def apply_async(fun, *args, **kwargs) -> ApplyExpression:
    from .internals.udfs import async_apply_expression

    return async_apply_expression(fun, args, kwargs)


def if_else(if_clause, then_clause, else_clause) -> IfElseExpression:
    return IfElseExpression(if_clause, then_clause, else_clause)


def coalesce(*args) -> CoalesceExpression:
    return CoalesceExpression(*args)


def require(val, *deps) -> RequireExpression:
    return RequireExpression(val, *deps)


def make_tuple(*args) -> MakeTupleExpression:
    return MakeTupleExpression(*args)


def cast(target_type, expr) -> CastExpression:
    return CastExpression(target_type, expr)


def unwrap(expr) -> ConvertExpression:
    return ConvertExpression(unwrap_value, wrap(expr))


def fill_error(expr, replacement) -> FillErrorExpression:
    return FillErrorExpression(expr, replacement)


def declare_type(target_type, expr) -> ColumnExpression:
    e = wrap(expr)
    e._dtype = _dt.wrap(target_type)
    return e


def assert_table_has_schema(table: Table, schema, *, allow_superset: bool = True) -> None:
    for name, cd in schema.columns().items():
        if name not in table.column_names():
            raise AssertionError(f"missing column {name!r}")


# -- namespaces --------------------------------------------------------------
from . import debug  # noqa: E402
from . import demo  # noqa: E402
from . import faults  # noqa: E402
from . import io  # noqa: E402
from . import persistence  # noqa: E402
from . import stdlib  # noqa: E402
from .internals import udfs  # noqa: E402
from .internals.udfs import UDF, udf  # noqa: E402
from .stdlib import indexing, ml, ordered, stateful, statistical, temporal, utils  # noqa: E402
from .stdlib.temporal import (  # noqa: E402
    asof_join,
    asof_join_left,
    asof_join_outer,
    asof_join_right,
    asof_now_join,
    asof_now_join_inner,
    asof_now_join_left,
    interval,
    interval_join,
    interval_join_inner,
    interval_join_left,
    interval_join_outer,
    interval_join_right,
    intervals_over,
    session,
    sliding,
    tumbling,
    window_join,
    window_join_inner,
    window_join_left,
    window_join_outer,
    window_join_right,
)
from .stdlib.utils.async_transformer import AsyncTransformer  # noqa: E402
from .internals.iterate import iterate, iteration_limit  # noqa: E402
from .internals.row_transformer import (  # noqa: E402
    ClassArg,
    input_attribute,
    method,
    output_attribute,
    transformer,
)
from .internals.config import set_license_key, set_monitoring_config  # noqa: E402
from .internals.monitoring import MonitoringLevel  # noqa: E402
from .persistence import PersistenceMode  # noqa: E402
from .engine import time_ops as _time_ops  # noqa: E402

_time_ops.install_table_methods()
from .engine import stream_ops as _stream_ops  # noqa: E402

_stream_ops.install_table_methods()
from .internals.sql import sql  # noqa: E402
from .internals.yaml_loader import load_yaml  # noqa: E402

# temporal join/window methods grafted onto Table (reference:
# python/pathway/__init__.py:185-214)
Table.windowby = temporal.windowby
Table.interval_join = interval_join
Table.interval_join_inner = interval_join_inner
Table.interval_join_left = interval_join_left
Table.interval_join_right = interval_join_right
Table.interval_join_outer = interval_join_outer
Table.window_join = window_join
Table.window_join_inner = window_join_inner
Table.window_join_left = window_join_left
Table.window_join_right = window_join_right
Table.window_join_outer = window_join_outer
Table.asof_join = asof_join
Table.asof_join_left = asof_join_left
Table.asof_join_right = asof_join_right
Table.asof_join_outer = asof_join_outer
Table.asof_now_join = asof_now_join
Table.asof_now_join_inner = asof_now_join_inner
Table.asof_now_join_left = asof_now_join_left
Table.diff = ordered.diff
Table.interpolate = statistical.interpolate
Table.sort = temporal.sort

from .internals import universes  # noqa: E402
from .internals.interactive import LiveTable, enable_interactive_mode  # noqa: E402
from .internals.compat import (  # noqa: E402
    BaseCustomAccumulator,
    DateTimeNaive,
    DateTimeUtc,
    Duration,
    GroupedJoinResult,
    Joinable,
    OuterJoinResult,
    PyObjectWrapper,
    SchemaProperties,
    TableLike,
    TableSlice,
    Type,
    global_error_log,
    groupby,
    iterate_universe,
    join,
    join_inner,
    join_left,
    join_outer,
    join_right,
    local_error_log,
    pandas_transformer,
    schema_builder,
    schema_from_csv,
    table_transformer,
    wrap_py_object,
)
from .internals import udfs as asynchronous  # noqa: E402  (reference alias)
from .stdlib import graphs  # noqa: E402
from .stdlib.temporal import _window as window  # noqa: E402
from .stdlib.temporal._asof_join import AsofJoinResult  # noqa: E402
from .stdlib.temporal._interval_join import IntervalJoinResult  # noqa: E402
from .stdlib.temporal._window_join import WindowJoinResult  # noqa: E402

__all__ = [
    "resolve_device", "resolve_dtype", "DType", "Schema", "ColumnDefinition",
    "column_definition", "schema_from_dict", "schema_from_pandas",
    "schema_from_types", "Table", "GroupedTable", "JoinResult", "Universe",
    "this", "left", "right", "reducers", "apply", "apply_with_type",
    "apply_async", "udf", "UDF", "udfs", "cast",
    "coalesce", "if_else", "require", "make_tuple", "unwrap", "fill_error",
    "declare_type", "ColumnExpression", "ColumnReference", "Json", "Pointer",
    "ERROR", "PENDING", "JoinMode", "INT", "FLOAT", "BOOL", "STR", "BYTES",
    "DATE_TIME_NAIVE", "DATE_TIME_UTC", "DURATION", "debug", "io", "run",
    "run_all", "indexing", "temporal", "ordered", "statistical", "stateful",
    "utils", "AsyncTransformer", "iterate", "iteration_limit", "window",
    "AsofJoinResult", "IntervalJoinResult", "WindowJoinResult",
    "set_license_key", "set_monitoring_config", "persistence",
    "PersistenceMode", "MonitoringLevel", "demo", "ml", "graphs", "sql",
    "load_yaml", "transformer", "ClassArg", "input_attribute",
    "output_attribute", "method", "universes", "LiveTable",
    "enable_interactive_mode", "assert_table_has_schema",
    "BaseCustomAccumulator", "DateTimeNaive", "DateTimeUtc", "Duration",
    "GroupedJoinResult", "Joinable", "OuterJoinResult", "PyObjectWrapper",
    "SchemaProperties", "TableLike", "TableSlice", "Type",
    "global_error_log", "groupby", "iterate_universe", "join", "join_inner",
    "join_left", "join_outer", "join_right", "local_error_log",
    "pandas_transformer", "schema_builder", "schema_from_csv",
    "table_transformer", "wrap_py_object",
]

# names of the JAX package the port does not have yet, with the ROADMAP
# item that ports them
_NOT_PORTED = {
    "viz": "stdlib/viz (ROADMAP queue A item 7)",
}


def __getattr__(name: str):
    if name in _NOT_PORTED:
        raise AttributeError(
            f"pathway_tpu_torch.{name} is not ported yet: {_NOT_PORTED[name]}")
    raise AttributeError(f"module 'pathway_tpu_torch' has no attribute {name!r}")
